"""The split of dgp_tpu_torch over a mesh of several devices, on the CPU
(the mesh is 2 or 3 CPU entries, as a machine with that many cards would
give): `utils.nb_seed`; the shares of `parallel.mesh.shard_rows`; the
plain versions of K1-K4 and the large-block route called share by share,
equal bit for bit to one call over all points; `ptrain` and
``train(sharded=True)`` equal to `train` bit for bit for a Vecchia DGP,
a node-wise one, one with a Hetero node and one through the large-block
route; the p* predictions of a gp, an emulator and an lgp equal to
`predict`, with more than one share computed; and one M-step of a
3-share split against dgp_tpu's with its latents sharded over the 8
virtual CPU devices.
"""
import numpy as np
import pytest
import torch

import dgp_tpu
from dgp_tpu.ops import pallas_vecchia as pv
from dgp_tpu.parallel import mesh as jmesh
import dgp_tpu_torch as dt
from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models import compiled as tcompiled
from dgp_tpu_torch.models import ensemble as tens
from dgp_tpu_torch.models import mstep as tmstep
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.parallel import mesh as pmesh
from dgp_tpu_torch.vecchia import core as vcore

torch.set_num_threads(1)

CPU = torch.device('cpu')


def _mesh(k):
    return (CPU,) * k


@pytest.fixture
def shares_seen(monkeypatch):
    """Every mesh is three CPU entries and a prediction's chunks hold 4
    queries (so that a small test has chunks to share out); records the
    number of shares of each split into more than one (a split into one
    share is the one-device call)."""
    seen = []
    real = pmesh.shard_rows

    def spy(n, mesh, chunk=1):
        out = real(n, mesh, chunk)
        if len(out) > 1:
            seen.append(len(out))
        return out
    monkeypatch.setattr(pmesh, 'shard_rows', spy)
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: _mesh(3))
    monkeypatch.setattr(tens, '_CHUNK', 4)
    return seen


def test_nb_seed_from_utils():
    from dgp_tpu_torch.utils import nb_seed
    assert nb_seed is dt.nb_seed


@pytest.mark.parametrize("n, k", [(2000, 3), (2040, 2), (2, 3), (1, 4), (0, 2)])
def test_shard_rows_cover_once(n, k):
    shares = pmesh.shard_rows(n, _mesh(k))
    assert len(shares) == max(1, min(n, k))
    covered = np.concatenate([np.arange(n)[sl] for _, sl in shares])
    np.testing.assert_array_equal(covered, np.arange(n))
    sizes = [sl.stop - sl.start for _, sl in shares]
    assert max(sizes) - min(sizes) <= 1 and all(d == CPU for d, _ in shares)


@pytest.mark.parametrize("n, k", [(20000, 2), (2049, 3), (100, 2)])
def test_shard_rows_of_whole_chunks(n, k):
    """A prediction's shares: whole chunks of 2048 queries, the one-device
    call's, covering 0..n once and differing by at most one chunk."""
    shares = pmesh.shard_rows(n, _mesh(k), 2048)
    covered = np.concatenate([np.arange(n)[c] for _, sl in shares
                              for c in pmesh.chunks(sl, 2048)])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert all(sl.start % 2048 == 0 for _, sl in shares)
    counts = [len(pmesh.chunks(sl, 2048)) for _, sl in shares]
    assert len(shares) == min(k, -(-n // 2048)) and max(counts) - min(counts) <= 1


# ----------------------------------------------------------------------
# the per-point functions, share by share
# ----------------------------------------------------------------------
def _vecchia_inputs(n, m, d=2, K=None, seed=0):
    """Ordered inputs (n, d) (with a leading axis of K candidates), targets,
    nugget multipliers and Vecchia neighbour sets of m predecessors."""
    rs = np.random.RandomState(seed)
    X = rs.rand(n, d)
    NN = -np.ones((n, m + 1), np.int64)
    for i in range(n):
        prev = np.argsort(((X[:i] - X[i]) ** 2).sum(1))[:m]
        NN[i, 0] = i
        NN[i, 1:1 + len(prev)] = prev
    Xc = X if K is None else X[None] + 0.05 * rs.randn(K, n, d)
    t = torch.as_tensor
    return t(Xc), t(rs.randn(n)), t(1 + rs.rand(n)), t(NN)


@pytest.mark.parametrize("m", [10, 70])
@pytest.mark.parametrize("K", [None, 4])
def test_llik_parts_split_equals_one_call(m, K):
    """K4 (m = 10) and its large-block route (m = 70), alone and with a
    candidate axis, over 3 ragged shares of n = 101."""
    n = 101
    X, y, nd, NN = _vecchia_inputs(n, m, K=K)
    length, nugget = torch.tensor([0.3, 0.5]), torch.tensor(1e-3)
    split = pmesh.Split(_mesh(3), n)
    one = vcore.llik_parts(X, y, NN, length, nugget, nd, 'matern2.5')
    parts = split.gathered(lambda dev, sl, rows: vcore.llik_parts(
        X, y, rows, length, nugget, nd, 'matern2.5', sl.start), split.cols(NN, 0))
    assert len(split) == 3
    for a, b in zip(one, parts):
        assert torch.equal(a, b)
    assert torch.equal(vcore.llik_total(*one, 0.7), vcore.llik_total(*parts, 0.7))


@pytest.mark.parametrize("m", [10, 70])
def test_cond_weights_split_equals_one_call(m):
    """K3 (m = 10) and its route (m = 70): weights, sigma and layout."""
    n = 101
    X, _, _, NN = _vecchia_inputs(n, m, seed=1)
    length, nugget = torch.tensor([0.4]), torch.tensor(1e-4)
    split = pmesh.Split(_mesh(3), n)
    one = vcore.cond_weights(X, NN, length, nugget, 'sexp')
    parts = split.run(lambda dev, sl, rows: vcore.cond_parts(
        X, rows, length, nugget, 'sexp', start=sl.start), split.cols(NN, 0))
    joined = vcore.join_weights(split.gather, parts, NN, X)
    two = vcore.cond_weights(X, NN, length, nugget, 'sexp', parts=joined)
    for a, b in zip(one, two):
        assert torch.equal(a, b) and a.stride() == b.stride()


def test_k2_split_equals_one_call():
    """K2's plain version on each share's columns of the angle views."""
    rs = np.random.RandomState(2)
    m1, d, n = 11, 2, 101
    A, B, C = (torch.as_tensor(rs.rand(m1, d, n)) for _ in range(3))
    yg, diag = torch.as_tensor(rs.randn(m1, n)), torch.as_tensor(1 + rs.rand(m1, n))
    cosv, sinv = [1.0, 0.6, -0.2], [0.0, 0.8, 0.98]
    split = pmesh.Split(_mesh(3), n)
    one = cv.block_loglik_multi_t(A, B, C, yg, diag, cosv, sinv, name='sexp', dl=1)
    parts = split.gathered(
        lambda dev, sl, *t: cv.block_loglik_multi_t(*t, cosv, sinv, name='sexp', dl=1),
        *(split.cols(t) for t in (A, B, C, yg, diag)))
    for a, b in zip(one, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", [False, True])
def test_k1_split_equals_one_call(route):
    """K1 (m1 = 11) and the route's autograd gradient (m1 = 71) of a group
    of two nodes at its full lanes, over 3 ragged shares: the per-point
    parts and the objective and gradient of `_vecch_fg`."""
    n, G, d = 101, 2, 2
    m1 = 71 if route else 11
    rs = np.random.RandomState(3)
    _, _, _, NN = _vecchia_inputs(n, m1 - 1, seed=3)
    raws = [cv.gather_raw_t(torch.as_tensor(rs.rand(n, d)), torch.as_tensor(rs.randn(n)),
                            NN, torch.ones(n, dtype=torch.float64)) for _ in range(G)]
    blk = {key: torch.stack([r[i] for r in raws])
           for i, key in enumerate(('Xg_raw', 'yg', 'nug_g', 'valid'))}
    lt_full = torch.log(torch.tensor([[0.3, 0.6, 1e-3], [0.5, 0.5, 1e-2]],
                                     dtype=torch.float64))
    split = pmesh.Split(_mesh(3), n)
    kw = dict(name='sexp', d_max=d, route=route)
    one = tmstep._block_parts(blk, lt_full, 0, **kw)
    parts = [{key: v for key, v in zip(blk, vals)}
             for vals in zip(*(split.cols(t) for t in blk.values()))]
    two = split.gathered(lambda dev, sl, b, lanes: tmstep._block_parts(
        b, lanes, sl.start, **kw), parts, split.copies(lt_full))
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    op = {'A': torch.eye(d + 1, dtype=torch.float64).expand(G, -1, -1),
          'b': torch.zeros(G, d + 1, dtype=torch.float64),
          'param_mask': torch.ones(G, d + 1, dtype=torch.float64),
          'prior_id': torch.zeros(G, dtype=torch.int64),
          'prior_coef': torch.zeros(G, 2, dtype=torch.float64),
          'scale_est': torch.ones(G, dtype=torch.bool),
          'nug_est_f': torch.ones(G, dtype=torch.float64),
          'sum_res': torch.zeros(G, dtype=torch.float64),
          'n_orig': torch.full((G,), float(n), dtype=torch.float64),
          'fixed_scale64': torch.ones(G, dtype=torch.float64)}
    f1 = tmstep._vecch_fg(lt_full, op, [blk], pmesh.Split(_mesh(1), n), name='sexp',
                          d_max=d, n=n, has_ref=False, route=route)
    f2 = tmstep._vecch_fg(lt_full, op, parts, split, name='sexp', d_max=d, n=n,
                          has_ref=False, route=route)
    for a, b in zip(f1, f2):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# ptrain and train(sharded=True) against train
# ----------------------------------------------------------------------
def _f(x):
    return np.sin(6 * x[:, :1]) + 0.5 * np.cos(11 * x[:, :1])


def _model(kind, seed=4):
    """A small DGP of each kind the split must carry."""
    rs = np.random.RandomState(2)
    n = {'vecchia': 60, 'nodewise': 60, 'hetero': 80, 'route': 70}[kind]
    X = rs.rand(n, 1) * 2 - 1
    Y = _f(X) + 0.05 * rs.randn(n, 1)
    top = dt.kernel(length=np.array([0.5]), nugget=1e-3, nugget_est=True,
                    scale_est=True, connect=np.arange(1))
    if kind == 'hetero':
        Y = Y + 0.1 * np.exp(X) * rs.randn(n, 1)
        layers = dt.combine([dt.kernel(length=np.array([0.5]), nugget=1e-3)],
                            [dt.kernel(length=np.array([0.5]), scale_est=True,
                                       connect=np.arange(1)) for _ in range(2)],
                            [dt.Hetero()])
    else:
        layers = dt.combine([dt.kernel(length=np.array([0.5]), nugget=1e-3)], [top])
    dt.nb_seed(seed)
    np.random.seed(seed)
    return dt.dgp(X, Y, layers, vecchia=True, m=65 if kind == 'route' else 10,
                  block=kind != 'nodewise', device='cpu')


_TRAINED = {}


def _trained(kind):
    """`train` over 6 iterations (NN refreshes after 2 and 4) of 3 sweeps
    each, once per kind."""
    if kind not in _TRAINED:
        m = _model(kind)
        m.train(N=6, ess_burn=2, disable=True)
        _TRAINED[kind] = m
    return _TRAINED[kind]


@pytest.mark.parametrize("how", ["ptrain", "sharded"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kind", ["vecchia", "nodewise", "hetero", "route"])
def test_split_training_equals_train(kind, k, how, monkeypatch):
    ref = _trained(kind)
    seen = []
    real = pmesh.shard_rows
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: _mesh(k))
    monkeypatch.setattr(pmesh, 'shard_rows',
                        lambda n, mesh, chunk=1: seen.append(len(mesh)) or real(n, mesh, chunk))
    vcore.reset_route_counts()
    m = _model(kind)
    if how == "ptrain":
        m.ptrain(N=6, ess_burn=2, disable=True)
    else:
        m.train(N=6, ess_burn=2, disable=True, sharded=True)
    # training splits over the k entries; the imputer's sampling after it
    # runs on the model's device alone, one share
    assert k in seen and set(seen) <= {1, k}
    if kind == 'route':
        assert all(v > 0 for v in vcore.route_counts().values())
    if kind == 'hetero':
        assert m.imp._engine().exact_draws['vecchia'] > 0
    for la, lb in zip(ref.all_layer, m.all_layer):
        for a, b in zip(la, lb):
            if a.type != 'gp':
                continue
            np.testing.assert_array_equal(a.para_path, b.para_path)
            np.testing.assert_array_equal(a.output, b.output)
            if a.R2 is not None:
                np.testing.assert_array_equal(a.R2, b.R2)
            np.testing.assert_array_equal(a.NNarray, b.NNarray)
    assert m.N == ref.N == 6


def test_split_computes_on_copies(monkeypatch):
    """Every share after the first computes on copies, also where its
    entry is the model's own device: on a mesh of two CPU entries the
    state, the statics, the angles, the ensemble's replica and the shares'
    outputs all go through `parallel.mesh.move`, each a copy with storage
    of its own, and `ptrain` and `ppredict` still equal `train` and
    `predict` bit for bit; the one-device calls copy nothing."""
    moved = []
    real = pmesh.move

    def spy(t, device):
        out = real(t, device)
        assert out.numel() == 0 or out.data_ptr() != t.data_ptr()
        assert torch.equal(out, t)
        moved.append(out.shape)
        return out
    monkeypatch.setattr(pmesh, 'move', spy)
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: _mesh(2))
    monkeypatch.setattr(tens, '_CHUNK', 4)
    ref = _trained('vecchia')
    m = _model('vecchia')
    m.ptrain(N=6, ess_burn=2, disable=True)
    assert moved
    for la, lb in zip(ref.all_layer, m.all_layer):
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a.para_path, b.para_path)
            np.testing.assert_array_equal(a.output, b.output)
    e = dt.emulator(m.estimate(), N=2, device='cpu')
    x = np.linspace(-1, 1, 41)[:, None]
    del moved[:]
    one = e.predict(x, m=15)
    assert not moved and not e._ens._replicas
    _same(e.ppredict(x, m=15), one)
    assert moved and list(e._ens._replicas) == ['cpu']
    _same(e.predict(x, m=15), one)


# ----------------------------------------------------------------------
# the p* predictions
# ----------------------------------------------------------------------
def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vecch", [False, True])
def test_gp_ppredict_splits(vecch, shares_seen):
    rs = np.random.RandomState(0)
    X = rs.rand(40, 2)
    Y = _f(X) + 0.02 * rs.randn(40, 1)
    np.random.seed(1)
    g = dt.gp(X, Y, dt.kernel(length=np.array([0.5, 0.5]), scale_est=True,
                              nugget_est=True), vecchia=vecch, m=10, device='cpu')
    g.train()
    x = rs.rand(23, 2)
    one = g.predict(x, m=12)
    assert not shares_seen
    _same(g.ppredict(x, m=12), one)
    _same(g.predict(x, m=12, sharded=True), one)
    _same(g.pmetric(x, method='ALM', score_only=True),
          g.metric(x, method='ALM', score_only=True))
    assert shares_seen and min(shares_seen) == 3


def test_emulator_ppredict_splits(shares_seen):
    m = _model('vecchia', seed=6)
    m.train(N=2, disable=True)
    e = dt.emulator(m.estimate(), N=2, device='cpu')
    x = np.linspace(-1, 1, 41)[:, None]
    one = e.predict(x, m=15)
    assert not shares_seen
    _same(e.ppredict(x, m=15), one)
    _same(e.ppredict(x, m=15, full_layer=True), e.predict(x, m=15, full_layer=True))
    _same(e.ploo(m.X, m=8), e.loo(m.X, m=8))
    _same(e.pmetric(x, method='VIGF', obj=m, score_only=True),
          e.metric(x, method='VIGF', obj=m, score_only=True))
    assert shares_seen and min(shares_seen) == 3


def test_emulator_ppredict_jitter_retry_splits(shares_seen, monkeypatch):
    """A chunk with a non-finite entry is computed again at the jitter
    rungs: split or not, each entry gets its first finite value."""
    m = _model('vecchia', seed=7)
    m.train(N=2, disable=True)
    e = dt.emulator(m.estimate(), N=2, device='cpu')
    x = np.linspace(-1, 1, 31)[:, None]
    real = vcore.gp_vecch

    def flaky(xq, *a):
        mean, var = real(xq, *a)
        if a[-1] == 0.0:     # the first try: rows beyond 0.5 fail
            mean = torch.where(xq[:, 0] > 0.5, float('nan'), mean)
        return mean, var
    monkeypatch.setattr(vcore, 'gp_vecch', flaky)
    one = e.predict(x, m=15)
    assert np.isfinite(one[0]).all()
    _same(e.ppredict(x, m=15), one)
    assert shares_seen and min(shares_seen) == 3


def test_lgp_ppredict_splits(shares_seen):
    X1 = np.linspace(0, 1, 9)[:, None]
    Y1 = (np.sin(7.5 * X1) + 1) / 2
    X2 = np.linspace(0, 1, 11)[:, None]
    Y2 = np.sin(2 * (2 * X2 - 1))
    dt.nb_seed(7)
    g = dt.gp(X1, Y1, dt.kernel(length=np.array([1.]), name='matern2.5',
                                scale_est=True), device='cpu')
    g.train()
    m2 = dt.dgp(X2, Y2, dt.combine(
        [dt.kernel(length=np.array([1.]), name='matern2.5')],
        [dt.kernel(length=np.array([1.]), name='matern2.5', scale_est=True,
                   connect=np.arange(1))]), device='cpu')
    m2.train(N=2, disable=True)
    system = dt.lgp([[dt.container(g.export(), local_input_idx=np.array([0]), device='cpu')],
                     [dt.container(m2.estimate(), local_input_idx=np.array([0]),
                                   device='cpu')]], N=2, device='cpu')
    z = np.linspace(0, 1, 17)[:, None]
    for vecch in (False, True):
        system.set_vecchia(vecch)
        one = system.predict(z, m=6)
        full = system.predict(z, m=6, full_layer=True)
        del shares_seen[:]
        _same(system.ppredict(z, m=6), one)
        _same(system.predict(z, m=6, full_layer=True, sharded=True), full)
        assert shares_seen and min(shares_seen) == 3


# ----------------------------------------------------------------------
# parity with dgp_tpu's sharded M-step
# ----------------------------------------------------------------------
def test_split_m_step_and_loglik_match_sharded_jax(monkeypatch):
    """tests/test_torch_train.py's M-step protocol (n = 200, m = 10, the
    JAX objective through its Pallas gradient kernel in interpret mode), the
    JAX engine's latents sharded over the 8 virtual CPU devices and the
    port's M-step and log-likelihood split into 3 shares: hyper-parameters
    to rtol 1e-6, `_gp_loglik` to rtol 1e-9, the bounds of that test."""
    import jax
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_train_spread as proto

    monkeypatch.setattr(pv, "use_pallas", lambda *a: True)
    X, Y = proto.data()
    dgp_tpu.nb_seed(0)
    jm = dgp_tpu.dgp(X, Y, proto.layers(dgp_tpu), vecchia=True, m=proto.M_NN)
    eng_j = jm.imp._engine()
    eng_t = tcompiled.CompiledDGP(layers_from_numpy(layers_to_numpy(jm.all_layer)),
                                  device='cpu')
    lat_j, par_j = jmesh.shard_latent_state(eng_j.get_state())
    jmesh.assert_sharded(lat_j[0], 8)
    nn_j = eng_j.get_nn_state()
    new_j = jax.jit(lambda lat, par, nn: eng_j._m_step(
        lat, par, nn, eng_j._chunk_static(nn)))(lat_j, par_j, nn_j)
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    shares = tcompiled._Shares(eng_t, nn_t, _mesh(3))
    shares.sync(lat_t, par_t)
    assert len(shares.split) == 3
    new_t = eng_t._m_step(lat_t, par_t, nn_t, shares)
    for pj, pt in zip(jax.tree_util.tree_leaves(new_j),
                      [v for layer in new_t for p in layer
                       for v in (p['length'], p['nugget'], p['scale'])]):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    assert float(new_t[1][0]['nugget']) != float(par_t[1][0]['nugget'])
    ref = jax.jit(lambda lat: eng_j._gp_loglik(1, 0, lat, par_j, nn_j))(lat_j)
    np.testing.assert_allclose(float(eng_t._gp_loglik(1, 0, lat_t, par_t, nn_t, shares)),
                               float(ref), rtol=1e-9)
