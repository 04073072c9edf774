"""The DGP emulator's methods of dgp_tpu_torch beyond `predict(method=
'mean_var')` against dgp_tpu, in float64 on the CPU, on imputations carried
across with `interop` (the JAX side at its initial latents, each imputation
perturbed by seeded noise, without drawing): `loo` (Vecchia and dense, with
and without replicated inputs), `predict(full_layer=True)` and
``method='sampling'`` under one numpy seed, the ALM / MICE / VIGF scores and
picks of `metric`, the ensemble's rebuild after `to_vecchia` /
`remove_vecchia`, and the byte-bounded query chunks of a dense LOO.

Tolerances: rtol 1e-9 on every moment, score and draw, with an absolute
floor of 1e-9 (on values of order 1) where a variance or a draw is a
difference of O(1) terms, as in tests/test_torch_lik.py."""
import copy

import numpy as np
import pytest

import dgp_tpu
from dgp_tpu.models import imputation as jimp
import dgp_tpu_torch
from dgp_tpu_torch.interop import dgp_from_numpy, layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models import ensemble as tens

TOL = dict(rtol=1e-9, atol=1e-9)


def _case(kind, rep, n=30, seed=0):
    """(X, Y, layers(pkg)) of a model kind: 'gp' a 2-layer GP-output DGP on
    two inputs, 'cat' [GP] -> [GP, global input] -> [Categorical()], 'pois'
    [GP] -> [Poisson()]; with ``rep`` the first 10 inputs come twice."""
    rs = np.random.RandomState(seed)
    d = 2 if kind == 'gp' else 1
    X = rs.rand(n, d)
    if rep:
        X = np.concatenate([X, X[:10]])
    x = X[:, 0]
    if kind == 'gp':
        Y = np.sin(3 * x) * np.cos(2 * X[:, 1]) + 0.05 * rs.randn(len(x))
    elif kind == 'cat':
        Y = (rs.rand(len(x)) < 0.5 + 0.4 * np.sin(6 * x)).astype(int)
    else:
        Y = rs.poisson(np.exp(1 + np.sin(5 * x))).astype(float)

    def layers(pkg):
        def k(**kw):
            return pkg.kernel(length=np.array([0.5]), nugget=1e-2, **kw)
        if kind == 'gp':
            return pkg.combine([k(), k()], [k(scale_est=True, nugget_est=True,
                                               connect=np.arange(2))])
        if kind == 'cat':
            return pkg.combine([k()], [k(scale_est=True, connect=np.arange(1))],
                               [pkg.Categorical()])
        return pkg.combine([k(scale_est=True)], [pkg.Poisson()])
    return X, Y.reshape(-1, 1), layers


_MODELS = {}


def _jax_model(kind, vecchia, rep):
    """A dgp_tpu model at its initial latents (its initial imputation, a
    compiled program per structure, left out)."""
    key = (kind, vecchia, rep)
    if key not in _MODELS:
        X, Y, layers = _case(kind, rep)
        dgp_tpu.nb_seed(5)
        sample = jimp.imputer.sample
        jimp.imputer.sample = lambda self, burnin=0: None
        try:
            _MODELS[key] = (dgp_tpu.dgp(X, Y, layers(dgp_tpu), vecchia=vecchia, m=8), X, Y)
        finally:
            jimp.imputer.sample = sample
    return _MODELS[key]


def _emulators(kind, vecchia, rep=False, N=3):
    """(JAX emulator, port emulator, JAX model, X, Y): N imputations of the
    model's latents perturbed by seeded noise, carried across."""
    model, X, Y = _jax_model(kind, vecchia, rep)
    sets = []
    for i in range(N):
        al = copy.deepcopy(model.all_layer)
        eng = dgp_tpu.models.compiled.CompiledDGP(al)
        lat, par = eng.get_state()
        rs = np.random.RandomState(30 + i)
        eng.set_state((tuple(a + 0.1 * rs.normal(size=a.shape) for a in lat), par))
        if not vecchia:
            jimp.imputer(al).key_stats()
        sets.append(al)
    emu_j = dgp_tpu.emulator.__new__(dgp_tpu.emulator)
    emu_j.all_layer, emu_j.n_layer, emu_j.vecch, emu_j.block = sets[0], len(sets[0]), vecchia, True
    emu_j.all_layer_set = sets
    emu_t = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in sets], device='cpu')
    return emu_j, emu_t, model, X, Y


def _close(a, b, tol=TOL):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, **tol)


# ----------------------------------------------------------------------
# loo
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vecchia", [True, False])
@pytest.mark.parametrize("rep", [False, True])
def test_loo_matches_jax(vecchia, rep):
    """Vecchia LOO drops each point's nearest neighbour, itself; a dense
    emulator conditions on all n - 1 others; replicated rows are predicted
    once and spread back."""
    emu_j, emu_t, model, X, _ = _emulators('gp', vecchia, rep)
    Xq = X if rep else model.X
    out_t = emu_t.loo(Xq, m=6)
    _close(out_t, emu_j.loo(Xq, m=6))
    assert out_t[0].shape == (len(Xq), 1)
    assert not any(nd.loo_state for s in emu_t.all_layer_set for layer in s
                   for nd in layer)
    assert all(nd.vecch == vecchia for s in emu_t.all_layer_set for nd in s[0])
    # a LOO mean differs from the plain prediction at the same point
    mu, _ = emu_t.predict(Xq, m=7 if vecchia else len(model.X))
    assert not np.allclose(mu, out_t[0])


# ----------------------------------------------------------------------
# full_layer and sampling
# ----------------------------------------------------------------------
CASES = [('gp', True), ('cat', False), ('pois', True)]


@pytest.mark.parametrize("kind,vecchia", CASES)
def test_full_layer_matches_jax(kind, vecchia):
    emu_j, emu_t, _, _, _ = _emulators(kind, vecchia)
    z = np.random.RandomState(3).rand(25, emu_t.all_layer[0][0].input.shape[1])
    mu_t, var_t = emu_t.predict(z, m=10, full_layer=True)
    mu_j, var_j = emu_j.predict(z, m=10, full_layer=True)
    assert len(mu_t) == emu_t.n_layer
    _close(mu_t, mu_j)
    _close(var_t, var_j)
    # the last entry is what predict gives without full_layer
    mu, var = emu_t.predict(z, m=10)
    np.testing.assert_array_equal(mu_t[-1].reshape(mu.shape), mu)


@pytest.mark.parametrize("full_layer", [False, True])
@pytest.mark.parametrize("kind,vecchia", CASES)
def test_sampling_matches_jax_under_one_numpy_seed(kind, vecchia, full_layer):
    """The draws come from numpy's global generator in the JAX package's
    order of calls, so one seed gives both packages the same draws."""
    emu_j, emu_t, _, _, _ = _emulators(kind, vecchia)
    z = np.random.RandomState(4).rand(20, emu_t.all_layer[0][0].input.shape[1])
    np.random.seed(11)
    s_t = emu_t.predict(z, method='sampling', full_layer=full_layer, sample_size=4, m=10)
    np.random.seed(11)
    s_j = emu_j.predict(z, method='sampling', full_layer=full_layer, sample_size=4, m=10)
    _close(s_t, s_j)
    last = s_t[-1] if full_layer else s_t
    assert all(a.shape == (20, 12) for a in last)
    if full_layer:
        assert len(s_t) == emu_t.n_layer


# ----------------------------------------------------------------------
# metric
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["ALM", "MICE", "VIGF"])
@pytest.mark.parametrize("kind,vecchia,rep", [('gp', True, False), ('gp', False, False),
                                              ('cat', True, False), ('pois', False, True)])
def test_metric_matches_jax(kind, vecchia, rep, method):
    """Scores and picks; 'cat' is a 3-layer likelihood model, 'pois' a
    2-layer one (MICE from the first layer's GP prediction)."""
    emu_j, emu_t, model, _, _ = _emulators(kind, vecchia, rep)
    obj = dgp_from_numpy(model, device='cpu')
    cand = np.random.RandomState(5).rand(40, emu_t.all_layer[0][0].input.shape[1])
    s_t = emu_t.metric(cand, method=method, obj=obj, m=10, score_only=True)
    s_j = emu_j.metric(cand, method=method, obj=model, m=10, score_only=True)
    _close(s_t, s_j)
    idx_t, val_t = emu_t.metric(cand, method=method, obj=obj, m=10)
    idx_j, val_j = emu_j.metric(cand, method=method, obj=model, m=10)
    np.testing.assert_array_equal(idx_t, idx_j)
    _close(val_t, val_j)


def test_metric_checks():
    _, emu_t, model, _, _ = _emulators('gp', True, True)
    cand = np.random.RandomState(5).rand(10, 2)
    with pytest.raises(Exception, match="obj"):
        emu_t.metric(cand, method='VIGF')
    with pytest.raises(Exception, match="replicates"):
        emu_t.metric(cand, method='VIGF', obj=dgp_from_numpy(model, device='cpu'))
    with pytest.raises(ValueError, match="unknown"):
        emu_t.metric(cand, method='PEI')
    with pytest.raises(Exception, match="2d-array"):
        emu_t.metric(cand[:, 0])


# ----------------------------------------------------------------------
# the ensemble's rebuild and the query chunks
# ----------------------------------------------------------------------
def test_ensemble_rebuilt_after_mode_switches():
    """After to_vecchia and remove_vecchia an emulator predicts what a
    freshly carried emulator in the same mode predicts."""
    emu_j, emu_t, _, _, _ = _emulators('gp', False)
    z = np.random.RandomState(6).rand(15, 2)
    dense = emu_t.predict(z, m=10)
    emu_t.to_vecchia()
    assert emu_t.vecch
    fresh_v = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set], device='cpu')
    for s in fresh_v.all_layer_set:
        for layer in s:
            for nd in layer:
                nd.vecch = True
    vecch = emu_t.predict(z, m=10)
    for a, b in zip(vecch, fresh_v.predict(z, m=10)):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(vecch[0], dense[0])
    with pytest.raises(Exception, match="already in Vecchia"):
        emu_t.to_vecchia()
    emu_t.remove_vecchia()
    fresh_d = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set], device='cpu')
    for a, b, c in zip(emu_t.predict(z, m=10), fresh_d.predict(z, m=10), dense):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(Exception, match="non-Vecchia"):
        emu_t.remove_vecchia()


@pytest.mark.parametrize("batch", [1, 7, None])
def test_dense_loo_chunks_change_nothing(batch, monkeypatch):
    """A dense emulator's LOO at chunks of 1, 7 and all queries: the same
    arrays."""
    _, emu_t, model, _, _ = _emulators('gp', False)
    whole = emu_t.loo(model.X)
    if batch is not None:
        monkeypatch.setattr(tens.CompiledEnsemble, 'query_batch', lambda self, m: batch)
        emu_t._ens = None
    for a, b in zip(emu_t.loo(model.X), whole):
        np.testing.assert_array_equal(a, b)


def test_query_batch_keeps_blocks_within_the_budget(monkeypatch):
    """Chunks of `_CHUNK` queries where the blocks are small, else as many
    as keep the widest node's blocks within QUERY_BUDGET, at least one."""
    _, emu_t, _, _, _ = _emulators('gp', True)
    ens = tens.CompiledEnsemble(emu_t.all_layer_set, 'cpu')
    assert ens.query_batch(25) == tens._CHUNK
    # layer 2's node: inputs of width 2 + 2, blocks of 31 rows at m = 30
    per_q = (8 + 4 * 4) * 31 ** 2 * 8
    monkeypatch.setattr(tens, 'QUERY_BUDGET', 7 * per_q + 5)
    assert ens.query_batch(30) == ens.query_batch(2000) == 7
    monkeypatch.setattr(tens, 'QUERY_BUDGET', per_q // 2)
    assert ens.query_batch(30) == 1
