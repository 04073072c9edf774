"""O7 of dgp_tpu_torch on the CPU: the device-mesh helpers
(`parallel.mesh`), the p* methods (`ppredict`, `ploo`, `pmetric`) of a gp,
a Vecchia DGP emulator and an lgp, equal bit for bit to the plain calls,
`dgp.ptrain` on one device and on a mesh of two (tests/test_torch_split.py
holds the split to train on more models and meshes), and
`utils.multistart` against dgp_tpu's.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
import dgp_tpu_torch as dt
from dgp_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

CPU = torch.device('cpu')
TWO = (CPU, CPU)


@pytest.fixture
def two_devices(monkeypatch):
    """Every model's mesh is two CPU entries."""
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: TWO)


def _f(x):
    return np.sin(6 * x[:, :1]) + 0.5 * np.cos(11 * x[:, :1])


# ----------------------------------------------------------------------
# mesh helpers
# ----------------------------------------------------------------------
def test_mesh_helpers_one_device_is_identity():
    mesh = pmesh.model_mesh('cpu')
    assert mesh == (CPU,)
    state = ((torch.zeros(4, 2),), ())
    assert pmesh.shard_latent_state(state, mesh) is state
    # on two entries: the state itself, then a copy of it on the second
    first, second = pmesh.shard_latent_state(state, TWO)
    assert first is state and torch.equal(second[0][0], state[0][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.device_mesh()


@pytest.mark.parametrize("cards", [1, 2])
def test_cuda_without_index_is_the_current_card(cards, monkeypatch):
    """``device='cuda'`` names the current card once: one card gives a
    one-entry mesh, on which `ptrain` trains (the CPU model's mesh is
    taken as that of 'cuda'); two cards give it and the other."""
    visible = tuple(torch.device('cuda', i) for i in range(cards))
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(pmesh, 'device_mesh', lambda: visible)
    real = pmesh.model_mesh
    for name in ('cuda', 'cuda:0', torch.device('cuda')):
        assert real(name) == visible
    if cards == 2:
        assert real('cuda:1') == visible[::-1]
        return
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: real('cuda'))
    m = _vecchia_dgp(5)
    m.ptrain(N=1, disable=True)
    assert m.N == 1


# ----------------------------------------------------------------------
# gp
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def gps():
    rs = np.random.RandomState(0)
    X = rs.rand(40, 2)
    Y = _f(X) + 0.02 * rs.randn(40, 1)
    k = dt.kernel(length=np.array([0.5, 0.5]), scale_est=True, nugget_est=True)
    g = dt.gp(X, Y, k, device='cpu')
    g.train()
    np.random.seed(1)
    gv = dt.gp(X, Y, dt.kernel(length=np.array([0.5, 0.5]), scale_est=True,
                               nugget_est=True), vecchia=True, m=10, device='cpu')
    gv.train()
    return g, gv, rs.rand(13, 2)


def _same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("vecch", [False, True])
def test_gp_ppredict_pmetric(gps, vecch):
    g, x = gps[int(vecch)], gps[2]
    _same(g.ppredict(x, m=12, chunk_num=3), g.predict(x, m=12))
    _same(g.predict(x, m=12, sharded=True), g.predict(x, m=12))
    for meth in ("ALM", "MICE", "VIGF"):
        _same(g.pmetric(x, method=meth, score_only=True, chunk_num=3, core_num=2),
              g.metric(x, method=meth, score_only=True))


# ----------------------------------------------------------------------
# Vecchia DGP emulator, ptrain, train(sharded=True)
# ----------------------------------------------------------------------
def _vecchia_dgp(seed):
    rs = np.random.RandomState(2)
    X = rs.rand(60, 1) * 2 - 1
    Y = _f(X) + 0.05 * rs.randn(60, 1)
    layers = dt.combine([dt.kernel(length=np.array([0.5]), nugget=1e-3)],
                        [dt.kernel(length=np.array([0.5]), nugget=1e-3, nugget_est=True,
                                   scale_est=True, connect=np.arange(1))])
    dt.nb_seed(seed)
    np.random.seed(seed)
    return dt.dgp(X, Y, layers, vecchia=True, m=10, device='cpu')


def test_ptrain_is_train():
    a = _vecchia_dgp(4)
    a.ptrain(N=2, disable=True, core_num=3)
    b = _vecchia_dgp(4)
    b.train(N=2, disable=True)
    for la, lb in zip(a.all_layer, b.all_layer):
        for na, nb in zip(la, lb):
            np.testing.assert_array_equal(na.para_path, nb.para_path)
            np.testing.assert_array_equal(na.output, nb.output)


def test_sharded_train_on_two_devices_equals_train(two_devices):
    """On a mesh of two entries `ptrain` splits SEM into two shares and
    trains as `train` does, bit for bit."""
    a = _vecchia_dgp(5)
    a.train(N=3, disable=True)
    m = _vecchia_dgp(5)
    m.ptrain(N=3, disable=True)
    assert m.N == 3
    for la, lb in zip(a.all_layer, m.all_layer):
        for na, nb in zip(la, lb):
            np.testing.assert_array_equal(na.para_path, nb.para_path)
            np.testing.assert_array_equal(na.output, nb.output)


@pytest.fixture(scope="module")
def emu():
    m = _vecchia_dgp(6)
    m.train(N=2, disable=True)
    return m, dt.emulator(m.estimate(), N=2, device='cpu')


def test_emulator_ppredict_ploo_pmetric(emu):
    m, e = emu
    x = np.linspace(-1, 1, 21)[:, None]
    _same(e.ppredict(x, m=15, chunk_num=2), e.predict(x, m=15))
    _same(e.predict(x, m=15, sharded=True), e.predict(x, m=15))
    full_p = e.ppredict(x, full_layer=True, m=15)
    full = e.predict(x, full_layer=True, m=15)
    for a, b in zip(full_p, full):
        _same(a, b)
    _same(e.ploo(m.X, m=8, core_num=4), e.loo(m.X, m=8))
    for meth in ("ALM", "VIGF"):
        _same(e.pmetric(x, method=meth, obj=m, score_only=True, chunk_num=2),
              e.metric(x, method=meth, obj=m, score_only=True))


# ----------------------------------------------------------------------
# lgp
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def system():
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
    c1 = dt.container(g.export(), local_input_idx=np.array([0]), device='cpu')
    c2 = dt.container(m2.estimate(), local_input_idx=np.array([0]), device='cpu')
    return dt.lgp([[c1], [c2]], N=2, device='cpu')


@pytest.mark.parametrize("vecch", [False, True])
def test_lgp_ppredict(system, vecch):
    system.set_vecchia(vecch)
    try:
        z = np.linspace(0, 1, 15)[:, None]
        b = system.predict(z, m=6)
        for a in (system.ppredict(z, m=6, chunk_num=2), system.predict(z, m=6, sharded=True)):
            for u, v in zip(a, b):
                _same(u, v)
    finally:
        system.set_vecchia(False)


# ----------------------------------------------------------------------
# multistart
# ----------------------------------------------------------------------
def _branin(cos):
    def neg_branin(x2d):
        x, y = x2d[:, 0], x2d[:, 1]
        a, b, c, r, s, t = 1, 5.1 / (4 * np.pi**2), 5 / np.pi, 6, 10, 1 / (8 * np.pi)
        val = a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * cos(x) + s
        return (-val).reshape(-1, 1)
    return neg_branin


LB, UB = np.array([-5.0, 0.0]), np.array([10.0, 15.0])


def test_multistart_torch_objective_matches_jax():
    """A torch objective takes the batched device path with no warning;
    from each start alone, the optimum equals dgp_tpu's vmapped device
    path at rtol 1e-9; from all starts, the best is Branin's minimum."""
    inits = np.random.RandomState(9).uniform(LB, UB, size=(6, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        best = dt.utils.multistart(_branin(torch.cos), inits, LB, UB, device='cpu')
        assert -_branin(np.cos)(best[None])[0, 0] < 0.5
        for x0 in inits[:4]:
            ours = dt.utils.multistart(_branin(torch.cos), x0[None], LB, UB, device='cpu')
            ref = dgp_tpu.utils.multistart(_branin(jnp.cos), x0[None], LB, UB)
            np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-12)


def test_multistart_numpy_objective_takes_scipy():
    """A numpy objective (dgp_tpu's `test_multistart` case) falls back to
    scipy's L-BFGS-B with dgp_tpu's RuntimeWarning and finds the minimum;
    ``int_mask`` rounds its dimension."""
    inits = np.random.RandomState(7).uniform(LB, UB, size=(8, 2))
    with pytest.warns(RuntimeWarning, match="falling back to scipy L-BFGS-B"):
        best = dt.utils.multistart(_branin(np.cos), inits, LB, UB, device='cpu')
    assert -_branin(np.cos)(best[None])[0, 0] < 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        best = dt.utils.multistart(_branin(torch.cos), inits, LB, UB, int_mask=[0],
                                   device='cpu')
    assert best[0] == np.round(best[0])


def test_multistart_non_finite_result_takes_scipy():
    """A torch objective whose batched result is not finite falls back."""
    def f(x2d):
        return torch.where(x2d[:, :1] > 0, torch.nan, -(x2d[:, :1] + 1) ** 2)
    with pytest.warns(RuntimeWarning, match="non-finite"):
        dt.utils.multistart(f, np.array([[0.5], [-0.5]]), np.array([-2.]), np.array([2.]),
                            device='cpu')
