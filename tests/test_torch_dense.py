"""Dense GP nodes and the 'ref' prior in dgp_tpu_torch's DGP engine,
against dgp_tpu, on the CPU in float64.  One structure carries every
prior: layer 1 holds a node with no prior, an 'inv_ga' node with length
bounds and a 'ga' node; layer 2 a 'ref' node wired to the global input,
with its nugget and scale estimated, over replicated data.

1. `interop` carries the priors, their coefficients as stored, the bounds
   and the replicates: the port's one-group M-step objective and bounds
   equal the JAX engine's, dense and Vecchia;
2. the dense M-step and the dense per-node log-likelihood (alone and for a
   batch of candidates) against the JAX engine, and the same for the
   'ref' prior on the Vecchia path, whose block ESS candidates go through
   K4 with a candidate axis instead of K2's angle views;
3. the dense ensemble predicts a JAX emulator's imputations as JAX does;
4. dense prior draws have the prior's covariance;
5. a short dense DGP training (the parity `step` config) stays finite, in
   block and node-wise ESS.
"""
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
from dgp_tpu.models import mstep as jmstep
import dgp_tpu_torch
from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models import ensemble as tens
from dgp_tpu_torch.models import mstep as tmstep
from dgp_tpu_torch.models.compiled import CompiledDGP, _Shares
from dgp_tpu_torch.ops import cuda_linked
from dgp_tpu_torch.ops import cuda_vecchia as cv

torch.set_num_threads(1)


def _data():
    rs = np.random.RandomState(0)
    X = rs.rand(24, 1)
    Y = np.sin(6 * X) + 0.05 * rs.randn(24, 1)
    # four replicated sites
    return np.vstack([X, X[:4]]), np.vstack([Y, Y[:4] + 0.03 * rs.randn(4, 1)])


def _layers(pkg):
    return pkg.combine(
        [pkg.kernel(length=np.array([0.5]), nugget=1e-3, prior_name=None),
         pkg.kernel(length=np.array([0.4]), nugget=1e-3, prior_name='inv_ga',
                    prior_coef=np.array([2.0, 0.4]), bds=[0.05, 3.0]),
         pkg.kernel(length=np.array([0.6]), nugget=1e-3)],
        [pkg.kernel(length=np.array([0.5, 0.6, 0.3, 0.7]), scale_est=True,
                    nugget_est=True, nugget=1e-2, connect=np.arange(1),
                    prior_name='ref')])


def _jax_model(vecchia):
    X, Y = _data()
    dgp_tpu.nb_seed(0)
    return dgp_tpu.dgp(X, Y, _layers(dgp_tpu), vecchia=vecchia, m=8)


class _Models(dict):
    """mode -> (JAX model, JAX engine, port engine on the carried state),
    each built on first use."""

    def __missing__(self, mode):
        mj = _jax_model(mode == "vecch")
        eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(mj.all_layer)),
                            device='cpu')
        self[mode] = (mj, mj.imp._engine(), eng_t)
        return self[mode]


@pytest.fixture(scope="module")
def models():
    return _Models()


def _states(eng_j, eng_t):
    return (eng_j.get_state(), eng_j.get_nn_state(),
            eng_t.get_state(), eng_t.get_nn_state())


# ----------------------------------------------------------------------
# 1. interop and the one-group objective
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ("dense", "vecch"))
def test_interop_carries_priors_and_bounds(models, mode):
    """Every node of the structure in one M-step group, at the starting
    parameters and at a shifted point: the port's objective equals the JAX
    engine's at rtol 1e-9, and the bounds are equal."""
    _, eng_j, eng_t = models[mode]
    for nj, nt in zip((n for layer in eng_j.all_layer for n in layer),
                      (n for layer in eng_t.all_layer for n in layer)):
        assert nt.prior_name == nj.prior_name
        for key in ('prior_coef', 'bds', 'W_diag', 'sum_residual', 'rep'):
            a, b = getattr(nt, key), getattr(nj, key)
            assert (a is None) == (b is None), key
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    (lat_j, par_j), nn_j, (lat_t, par_t), nn_t = _states(eng_j, eng_t)
    cs_j = eng_j._chunk_static(nn_j)
    es = [(l, k) for l, layer in enumerate(eng_t.spec) for k in range(len(layer))]
    d_max = max(eng_t.spec[l][k].D for l, k in es)
    p_max = max(eng_t.spec[l][k].n_length + eng_t.spec[l][k].nugget_est for l, k in es)
    built = [eng_t._node_operands(l, k, eng_t.spec[l][k], lat_t, par_t, d_max, p_max)
             for l, k in es]
    shares = _Shares(eng_t, nn_t)
    shares.sync(lat_t, par_t)
    ops = {key: torch.stack([b[0][key] for b in built]) for key in built[0][0]}
    lt0 = torch.stack([b[1] for b in built])
    for shift in (0.0, 0.2):
        lt = lt0 + shift * (torch.stack([b[2] for b in built]) != 0)
        if mode == "dense":
            nll_t = tmstep._dense_fg(lt, ops, name='sexp', n=eng_t.n, has_ref=True)[0]
        else:
            parts = eng_t._group_blocks([(l, k, eng_t.spec[l][k]) for l, k in es],
                                        d_max, shares)
            nll_t = tmstep._vecch_fg(lt, ops, parts, shares.split, name='sexp',
                                     d_max=d_max, n=eng_t.n, has_ref=True)[0]
        for i, (l, k) in enumerate(es):
            op_j, _, lb_j, ub_j, _ = eng_j._node_operands(
                l, k, eng_j.spec[l][k], lat_j, par_j, nn_j, d_max, p_max, mode, cs_j)
            fn = jmstep._dense_nll if mode == "dense" else jmstep._vecch_nll_xla
            ref, _ = fn(jnp.asarray(lt[i].numpy()), op_j, name='sexp', n=eng_j.n)
            np.testing.assert_allclose(float(nll_t[i]), float(ref), rtol=1e-9)
            np.testing.assert_array_equal(built[i][2].numpy(), np.asarray(lb_j))
            np.testing.assert_array_equal(built[i][3].numpy(), np.asarray(ub_j))


# ----------------------------------------------------------------------
# 2. the M-step and the per-node log-likelihood
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ("dense", "vecch"))
def test_m_step_and_loglik_match_jax(models, mode):
    """One M-step of every node at rtol 1e-6 (16 Armijo decisions amplify
    the ~1e-12 objective gaps), and the 'ref' node's log-likelihood, alone
    and for three candidate inputs in one call, at rtol 1e-9."""
    _, eng_j, eng_t = models[mode]
    (lat_j, par_j), nn_j, (lat_t, par_t), nn_t = _states(eng_j, eng_t)
    new_j = jax.jit(lambda lat, par, nn: eng_j._m_step(
        lat, par, nn, eng_j._chunk_static(nn)))(lat_j, par_j, nn_j)
    new_t = eng_t._m_step(lat_t, par_t, nn_t)
    for pj, pt in zip(jax.tree_util.tree_leaves(new_j),
                      [v for layer in new_t for p in layer
                       for v in (p['length'], p['nugget'], p['scale'])]):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    assert float(new_t[1][0]['nugget']) != float(par_t[1][0]['nugget'])
    ref = jax.jit(lambda lat: eng_j._gp_loglik(1, 0, lat, par_j, nn_j))
    np.testing.assert_allclose(float(eng_t._gp_loglik(1, 0, lat_t, par_t, nn_t)),
                               float(ref(lat_j)), rtol=1e-9)
    cands = (np.asarray(lat_j[0])[None]
             + 0.1 * np.random.RandomState(1).normal(size=(3,) + tuple(lat_t[0].shape)))
    batched = eng_t._gp_loglik(1, 0, (torch.as_tensor(cands),), par_t, nn_t)
    np.testing.assert_allclose(batched.numpy(),
                               [float(ref((jnp.asarray(c),))) for c in cands], rtol=1e-9)


def test_ref_layer_block_ess_goes_through_k4(models, monkeypatch):
    """The layer under a 'ref' node has no angle views: a block ESS sweep
    evaluates each round's candidates in one K4 call with a candidate axis
    and never calls K2."""
    _, _, eng_t = models["vecch"]
    (lat, par), nn = eng_t.get_state(), eng_t.get_nn_state()
    calls = []
    orig = cv.block_loglik_parts_t

    def parts(Xg, *a, **kw):
        calls.append(tuple(Xg.shape))
        return orig(Xg, *a, **kw)

    def multi(*a, **kw):
        raise AssertionError("K2 called for a 'ref' layer")

    monkeypatch.setattr(cv, "block_loglik_parts_t", parts)
    monkeypatch.setattr(cv, "block_loglik_multi_t", multi)
    shares = _Shares(eng_t, nn)
    assert eng_t._build_angle_plan(0, lat, par, shares.items[0], None, 1) is None
    dgp_tpu_torch.nb_seed(2)
    gens = (torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))
    new, _ = eng_t._ess_block_layer(0, lat, None, par, nn, gens, shares)
    assert calls and all(len(s) == 4 and s[0] > 1 for s in calls), calls
    assert torch.isfinite(new[0]).all() and not torch.equal(new[0], lat[0])


# ----------------------------------------------------------------------
# 3. the dense ensemble
# ----------------------------------------------------------------------
def test_dense_ensemble_predicts_carried_imputations(models, monkeypatch):
    """A JAX emulator's imputations of the dense structure (three hidden
    nodes, linked final layer with replicate weights), carried across:
    mean and variance at rtol 1e-8, and with the dense linked layer's
    queries in batches bounded by `cuda_linked.LINK_BUDGET`."""
    mj = models["dense"][0]
    emu_j = dgp_tpu.emulator(mj.estimate(), N=3)
    z = np.linspace(0, 1, 60).reshape(-1, 1)
    mu_j, var_j = emu_j.predict(z)
    emu_t = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set],
        device='cpu')
    mu_t, var_t = emu_t.predict(z)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var_t, var_j, rtol=1e-8, atol=1e-10)
    assert tens.supported(emu_t.all_layer_set) is None
    # a budget of 7 queries' (n, n) moments: the linked layer's queries go
    # in batches of at most 7, and the predictions do not move
    batches = []
    inner = cuda_linked.linked_dense_t_plain

    def spy(X, m, *a, **kw):
        batches.append(m.shape[0])
        return inner(X, m, *a, **kw)

    monkeypatch.setattr(cuda_linked, "LINK_BUDGET", 7 * 3 * 24 ** 2 * 8)
    monkeypatch.setattr(cuda_linked, "linked_dense_t_plain", spy)
    mu_b, var_b = emu_t.predict(z)
    assert batches and min(batches) <= 7 and 60 in batches
    np.testing.assert_allclose(mu_b, mu_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var_b, var_j, rtol=1e-8, atol=1e-10)


# ----------------------------------------------------------------------
# 4-5. prior draws and training
# ----------------------------------------------------------------------
def _step_model(block, seed=0):
    """The parity `step` config (tools/parity.py:52-69): 3-layer sexp DGP,
    n=10, exact step."""
    X = np.linspace(0, 1., 10)[:, None]
    Y = np.where(X < 0.5, -1.0, 1.0)
    k = dgp_tpu_torch.kernel
    all_layer = dgp_tpu_torch.combine([k(length=np.array([1.]))],
                                      [k(length=np.array([1.]))],
                                      [k(length=np.array([1.]), scale_est=True)])
    dgp_tpu_torch.nb_seed(seed)
    return dgp_tpu_torch.dgp(X, [Y], all_layer, block=block, device='cpu')


def test_dense_prior_draws_have_the_prior_covariance():
    """20000 batched draws and 2000 single draws of a hidden dense node:
    every entry of the sample covariance within 5 standard errors of
    scale * K."""
    m = _step_model(True)
    eng = m.imp._engine()
    lat, par = eng.get_state()
    par = (par[0], ({**par[1][0], 'scale': torch.tensor(1.7, dtype=torch.float64)},),
           par[2])
    Xn = eng._node_input(1, 0, lat)
    p = par[1][0]
    from dgp_tpu_torch.ops import kernels as kops
    K = (p['scale'] * kops.k_matrix(Xn, p['length'], p['nugget'], 'sexp')).numpy()
    gen = torch.Generator().manual_seed(5)
    batch = eng._draw_prior_node_batch(1, 0, lat, par, None, gen, 20000).numpy()
    single = np.stack([eng._draw_prior_node(1, 0, lat, par, None, gen).numpy()
                       for _ in range(2000)])
    for draws in (batch, single):
        S = len(draws)
        C = draws.T @ draws / S
        se = np.sqrt((K ** 2 + np.outer(np.diag(K), np.diag(K))) / S)
        assert np.all(np.abs(C - K) <= 5 * se), np.max(np.abs(C - K) / se)
    first = eng._draw_prior_node_batch(0, 0, lat, par, None, gen, 3)
    assert first.shape == (3, 10) and torch.isfinite(first).all()


@pytest.mark.parametrize("block", (True, False))
def test_dense_step_config_trains_finite(block):
    m = _step_model(block, seed=1)
    m.train(N=3, disable=True)
    assert m.N == 3
    for layer in m.all_layer:
        for node in layer:
            assert node.para_path.shape[0] == 4 and np.isfinite(node.para_path).all()
            assert not node.vecch and node.NNarray is None
    emu = dgp_tpu_torch.emulator(m.estimate(), N=2, device='cpu')
    mu, var = emu.predict(np.linspace(0, 1, 25)[:, None])
    assert mu.shape == (25, 1) and np.isfinite(mu).all() and (var > 0).all()
    assert all(nd['Rinv'].shape[-1] == 10 and torch.isfinite(nd['Rinv_y']).all()
               for layer in emu._ens.spec for nd in layer)


def test_dense_entry_points_without_device_need_cuda(monkeypatch):
    """Dense dgp and emulator run on the card by default; without one they
    raise and name device='cpu'."""
    m = _step_model(True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.linspace(0, 1., 10)[:, None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dgp_tpu_torch.dgp(X, np.sin(X), [[dgp_tpu_torch.kernel(length=np.array([1.]))]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dgp_tpu_torch.emulator(m.all_layer, N=1)


def test_no_o1_raises_left():
    pkg = Path(dgp_tpu_torch.__file__).parent
    for src in pkg.rglob("*.py"):
        assert "O1)" not in src.read_text(), src
