"""K6 `vecchia_pred` (`dgp_tpu_torch/csrc/vecchia_pred.cu`, wrappers in
`dgp_tpu_torch/ops/cuda_pred.py`): a Vecchia node's prediction in one
launch, behind `vecchia.core.gp_vecch` and `link_gp_vecch`.

On the CPU:
1. the entry points give, bit for bit, what they gave before K6 (the
   bodies kept below as `_gp_vecch_before` and `_link_gp_vecch_before`):
   sexp and matern2.5, with and without a global input, neighbour rows
   with -1 lanes, fewer training points than `pred_m`, and a number of
   queries that fills no whole thread block;
2. the gate (`cuda_vecchia.use_kernel("K6", ...)`) at blocks of 51, 64
   and 65 rows, and ``kernel.plain_calls.K6`` for a CPU call outside it;
3. `vecchia/api.py` and `models/ensemble.py` reach the module attributes
   `vecchia.core.gp_vecch` and `link_gp_vecch`, which the benchmark hooks;
4. the kernel's arithmetic, written out in torch (the mean from the
   forward substitution's last row; K^-1 by columns and J pair by pair
   with its rows' weights), gives the plain values;
5. the shared-memory formula of the gate is the source's, and a wrapper
   refuses a tensor off the card before anything is built.

The tests marked ``card`` hold K6 to the plain versions on an NVIDIA card
(tolerances in their docstrings), check that a query's values are the
same bit for bit whatever call it comes in, that a block that is not
positive definite comes back NaN and the callers' retry then matches the
plain path, that blocks above the gate take the plain route, and that one
`lgp.predict` request of the lgp_n2000.predict cell's system makes 11 K6
launches.  This file imports no JAX; on the card:
``python -m pytest tests/test_torch_vecch_pred.py -m card --noconftest``.
"""
from functools import partial

import numpy as np
import pytest
import torch

import dgp_tpu_torch as dt
from dgp_tpu_torch import tracing
from dgp_tpu_torch.models.node import read_out
from dgp_tpu_torch.ops import cuda_pred as cp
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.ops import kernels as kops
from dgp_tpu_torch.ops import linalg, moments
from dgp_tpu_torch.vecchia import core as vcore


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


# ----------------------------------------------------------------------
# the bodies before K6
# ----------------------------------------------------------------------
def _eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def _pred_blocks_before(x, w_train, NNarray, y, length, nugget, nugget_diag, name):
    valid = NNarray >= 0
    safe = torch.where(valid, NNarray, 0)
    Xi = torch.cat([w_train[safe], x[:, None, :]], dim=1)
    yi = torch.where(valid, y[safe], 0.0)
    nug = torch.cat([nugget * nugget_diag[safe],
                     torch.broadcast_to(torch.as_tensor(nugget, dtype=x.dtype,
                                                        device=x.device),
                                        (x.shape[0], 1))], dim=1)
    K = kops.k_cross(Xi, Xi, length, name)
    valid_full = torch.cat([valid, torch.ones((x.shape[0], 1), dtype=torch.bool,
                                              device=x.device)], dim=1)
    both = valid_full[:, :, None] & valid_full[:, None, :]
    K = torch.where(both, K, _eye_like(K))
    K = kops.set_diag(K, torch.where(valid_full, 1.0 + nug + vcore._f32_jitter(K.dtype), 1.0))
    return K, yi


def _gp_vecch_before(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
                     extra_jit=0.0):
    K, yi = _pred_blocks_before(x, w_train, NNarray, y, length, nugget, nugget_diag, name)
    K = K + extra_jit * _eye_like(K)
    L = linalg.chol_small(K)
    Ly = linalg.fwd_solve_small(L[:, :-1, :-1], yi)
    mean = torch.einsum('ij,ij->i', L[:, -1, :-1], Ly)
    var = scale * L[:, -1, -1] ** 2
    return mean, var


def _link_gp_vecch_before(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget,
                          nugget_diag, name, extra_jit=0.0):
    Dw = w1.shape[1]
    Dz = 0 if z is None else z.shape[1]
    full_len = torch.broadcast_to(length, (Dw + Dz,))
    length_w, length_z = full_len[:Dw], full_len[Dw:]
    ok = NNarray >= 0
    idx = torch.where(ok, NNarray, 0)
    wi = w1[idx]
    yi = torch.where(ok, y[idx], 0.0)
    nug_i = nugget * nugget_diag[idx] + extra_jit
    I, J = moments.IJ(wi, m, v, length_w, name)
    if z is not None:
        gwi = global_w1[idx]
        Iz = kops.k_vec(gwi, z, length_z, name)
        I = I * Iz
        J = J * (Iz[:, :, None] * Iz[:, None, :])
        Xi = torch.cat([wi, gwi], dim=2)
    else:
        Xi = wi
    both = ok[:, :, None] & ok[:, None, :]
    I = torch.where(ok, I, 0.0)
    J = torch.where(both, J, 0.0)
    K = kops.k_cross(Xi, Xi, full_len, name)
    K = torch.where(both, K, _eye_like(K))
    K = kops.set_diag(K, torch.where(ok, 1.0 + nug_i + vcore._f32_jitter(K.dtype), 1.0))
    L = linalg.chol_small(K)
    Rinv_y = linalg.bwd_solve_small(L, linalg.fwd_solve_small(L, yi))
    A = torch.linalg.solve_triangular(L, J, upper=False)
    N = torch.linalg.solve_triangular(L, A.transpose(-1, -2), upper=False)
    tr = torch.diagonal(N, dim1=-2, dim2=-1).sum(-1)
    mu = torch.sum(I * Rinv_y, dim=-1)
    var = torch.abs(linalg.quad_form(J, Rinv_y) - mu**2 + scale * (1.0 + nugget - tr))
    return mu, var


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
def _nearest(q, X, k):
    """(M, k) int64: each query's k nearest rows of X, the nearest last,
    in chunks of queries."""
    out = []
    for s in range(0, q.shape[0], 1000):
        d2 = ((q[s:s + 1000, None, :] - X[None]) ** 2).sum(-1)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices.flip(1))
    return torch.cat(out)


def _case(kind, name, n, M, k, Dw, Dz, *, holes=False, seed=0, dtype=torch.float64,
          device="cpu", nugget=1e-3, nd=None, dup=False):
    """A call's arguments: n training points of [0, 1]^(Dw + Dz), M queries,
    each with its k nearest training points (length-scaled, nearest last,
    as the predictions order them); with ``holes`` a third of the rows lose
    their first k // 3 lanes to -1; matern2.5's linked queries are
    deterministic in dim 0 at every other row.  ``nd`` replaces the
    nugget multipliers, and with ``dup`` training point 1 is point 0."""
    rs = np.random.RandomState(seed)
    D = Dw + Dz
    X = rs.uniform(0, 1, (n, D))
    if dup:
        X[1] = X[0]
    y = np.sin(4 * X.sum(1)) + 0.1 * rs.randn(n)
    length = rs.uniform(0.2, 0.6, D)
    ndv = rs.uniform(0.5, 2.0, n) if nd is None else nd
    q = rs.uniform(0, 1, (M, D))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    f64 = lambda a: torch.as_tensor(a / length, device=device)
    NNt = _nearest(f64(q), f64(X), k)
    if holes:
        NNt[::3, : k // 3] = -1
    if kind == "kriging":
        return (t(q), t(X), NNt, t(y), 1.3, t(length), nugget, t(ndv), name)
    v = rs.uniform(0.001, 0.05, (M, Dw))
    if name == "matern2.5":
        v[::2, 0] = 0.0
    z = t(q[:, Dw:]) if Dz else None
    gw = t(X[:, Dw:]) if Dz else None
    return (t(q[:, :Dw]), t(v), z, t(X[:, :Dw]), gw, NNt, t(y), 1.3, t(length), nugget,
            t(ndv), name)


ENTRY = {"kriging": (vcore.gp_vecch, _gp_vecch_before),
         "linked": (vcore.link_gp_vecch, _link_gp_vecch_before)}


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["kriging", "linked"])
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("shape", [
    dict(n=60, M=13, k=20, Dw=1, Dz=0),                 # M fills no thread block
    dict(n=60, M=9, k=12, Dw=2, Dz=1, holes=True),      # -1 lanes, a global input
    dict(n=30, M=7, k=30, Dw=1, Dz=1),                  # n < pred_m: every point
    dict(n=90, M=11, k=40, Dw=1, Dz=0, holes=True),     # two rows a lane on the card
], ids=["ragged-M", "holes-z", "n-below-pred_m", "two-rows"])
def test_cpu_entry_points_give_the_previous_results_bit_for_bit(kind, name, shape):
    args = _case(kind, name, seed=shape["n"] + shape["k"], **shape)
    entry, before = ENTRY[kind]
    tracing.reset("kernel.")
    for extra in (0.0, 3e-4):
        out, ref = entry(*args, extra), before(*args, extra)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
        assert all(torch.isfinite(o).all() for o in out)
    assert tracing.totals("kernel.") == {}


@pytest.mark.parametrize("m1,inside", [(51, True), (64, True), (65, False)])
@pytest.mark.parametrize("kind", ["kriging", "linked"])
def test_gate_and_plain_calls(kind, m1, inside):
    """K6 takes blocks of up to 64 rows: the kriging block is k + 1 rows
    (the query last), the linked one k.  A CPU call outside the gate counts
    one ``kernel.plain_calls.K6``; inside it none; neither launches."""
    for dtype in (torch.float64, torch.float32):
        assert cv.use_kernel("K6", m1, 2, dtype) is inside
    k = m1 - 1 if kind == "kriging" else m1
    args = _case(kind, "sexp", n=80, M=5, k=k, Dw=1, Dz=1, seed=m1)
    cv.reset_launch_counts()
    out = ENTRY[kind][0](*args)
    ref = ENTRY[kind][1](*args)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert cv.launch_counts()["vecchia_pred_t"] == {"launches": 0,
                                                    "plain_calls": 0 if inside else 1}


@pytest.mark.parametrize("m1,d_last", [(64, 195), (51, 252), (32, 415)])
def test_gate_shared_memory_bound(m1, d_last):
    """K6 keeps two tiles of a query's d dims beside its block, so a
    thread block of one query fits the SM's 227 KB in float64 up to d_last
    dims; wider blocks are outside the gate."""
    assert cv.use_kernel("K6", m1, d_last)
    assert not cv.use_kernel("K6", m1, d_last + 1)
    assert cv.shared_bytes("K6", m1, d_last, torch.float64) <= cv.SMEM_MAX


def test_shared_bytes_formula_is_the_source():
    src = " ".join((cv._CSRC / "vecchia_pred.cu").read_text().split())
    assert "return m1 * (2 * d + 3) + 3 * d + pred_warp_scratch<R>(m1);" in src
    assert "return block_scratch<R>(m1, KEEP_L) + (R == 1 ? WARP : 0);" in src
    # the cell's kriging block (m1 = 51, d = 1) in float64: two queries of a
    # thread block, each with its tiles, the (32, LDS) array, L11's and
    # L21's (19, LDS) arrays and two column buffers
    assert cv.shared_bytes("K6", 51, 1, torch.float64) == \
        2 * 8 * (51 * 5 + 3 + 32 * 33 + 2 * 19 * 33 + 64)


def _recorded(monkeypatch):
    """Every call of the two entry points, by name, through their module
    attributes."""
    seen = []
    for attr in ("gp_vecch", "link_gp_vecch"):
        real = getattr(vcore, attr)

        def hooked(*a, _real=real, _attr=attr, **k):
            seen.append(_attr)
            return _real(*a, **k)
        monkeypatch.setattr(vcore, attr, hooked)
    return seen


def test_api_and_ensemble_reach_the_module_attributes(monkeypatch):
    """The benchmark counts the two entry points' work by hooking them on
    `vecchia.core`: `gp.predict`, `lgp.predict` and an emulator's predict
    all call them there."""
    seen = _recorded(monkeypatch)
    rs = np.random.RandomState(3)
    X = rs.uniform(-1, 1, (40, 1))
    x = np.linspace(-0.9, 0.9, 7)[:, None]
    g = dt.gp(X, np.sin(3 * X), dt.kernel(length=np.array([0.5]), nugget=1e-3),
              vecchia=True, m=10, device='cpu')
    g.predict(x, m=12)
    assert seen == ["gp_vecch"]
    dt.nb_seed(0)
    m2 = dt.dgp(X, np.cos(2 * X), [[dt.kernel(length=np.array([0.5]), name='sexp')],
                                   [dt.kernel(length=np.array([0.5]), name='sexp',
                                              scale_est=True, nugget_est=True)]],
                vecchia=True, m=10, device='cpu')
    system = dt.lgp([[dt.container(g.export(), local_input_idx=np.array([0]), device='cpu')],
                     [dt.container(m2.estimate(), local_input_idx=np.array([0]),
                                   device='cpu')]], N=2, device='cpu')
    del seen[:]
    system.predict(x, m=12)
    assert "gp_vecch" in seen and "link_gp_vecch" in seen
    del seen[:]
    dt.emulator(m2.estimate(), N=2, device='cpu').predict(x, m=12)
    assert "gp_vecch" in seen and "link_gp_vecch" in seen


def _kriging_arith(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
                   extra_jit=0.0):
    """K6's kriging in torch: the forward substitution of [y, 0] through the
    whole block, mean = -(L^-1 [y, 0])_k L[k, k]."""
    K, yi = _pred_blocks_before(x, w_train, NNarray, y, length, nugget, nugget_diag, name)
    L = linalg.chol_small(K + extra_jit * _eye_like(K))
    b = linalg.fwd_solve_small(L, torch.cat([yi, torch.zeros_like(yi[:, :1])], 1))
    return -b[:, -1] * L[:, -1, -1], scale * (L[:, -1, -1] * L[:, -1, -1])


def _linked_arith(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget, nugget_diag,
                  name, extra_jit=0.0):
    """K6's linked moments in torch: K^-1 column by column from the factor,
    J pair by pair from the raw coordinates with the rows' weights (Iz and
    matern's dims of zero variance), sexp's constant applied to the sums."""
    Dw = w1.shape[1]
    Dz = 0 if z is None else z.shape[1]
    full = torch.broadcast_to(length, (Dw + Dz,))
    lw, lz = full[:Dw], full[Dw:]
    ok = NNarray >= 0
    idx = torch.where(ok, NNarray, 0)
    wi = torch.where(ok[..., None], w1[idx], 0.0)
    Xi = wi if z is None else torch.cat([wi, global_w1[idx]], 2)
    K = kops.k_cross(Xi, Xi, full, name)
    both = ok[:, :, None] & ok[:, None, :]
    K = torch.where(both, K, _eye_like(K))
    K = kops.set_diag(K, torch.where(ok, 1.0 + (nugget * nugget_diag[idx] + extra_jit)
                                     + vcore._f32_jitter(K.dtype), 1.0))
    L = linalg.chol_small(K)
    a = linalg.bwd_solve_small(L, linalg.fwd_solve_small(L, torch.where(ok, y[idx], 0.0)))
    k = K.shape[-1]
    cols = [linalg.bwd_solve_small(L, linalg.fwd_solve_small(
        L, torch.broadcast_to(torch.eye(k, dtype=K.dtype)[c], a.shape))) for c in range(k)]
    Kinv = torch.stack(cols, -1)
    if name == "sexp":
        u = wi - m[:, None, :]
        p = u[:, :, None, :] + u[:, None, :, :]
        d = u[:, :, None, :] - u[:, None, :, :]
        l2 = lw * lw
        J = torch.exp(-(p * p / (2 * l2 + 8 * v[:, None, None, :])
                        + d * d / (2 * l2)).sum(-1))
        cI = torch.prod(1 / torch.sqrt(1 + 2 * v / l2), -1)
        Iw = cI[:, None] * torch.exp(-((wi - m[:, None, :]) ** 2 / (2 * v[:, None, :] + l2))
                                     .sum(-1))
        det = torch.ones_like(Iw)
        cJ = torch.prod(1 / torch.sqrt(1 + 4 * v / l2), -1)
    else:
        f = moments._i_matern_1d(m[:, None, :] - wi, v[:, None, :], lw)
        Iw = f.prod(-1)
        det = torch.where(v[:, None, :] > 0, torch.ones_like(f), f).prod(-1)
        vs = torch.where(v > 0, v, torch.ones_like(v))[:, None, None, :]
        jd = moments._jd_matern_1d(wi[:, :, None, :], wi[:, None, :, :],
                                   m[:, None, None, :], vs, lw)
        J = torch.where(v[:, None, None, :] > 0, jd, torch.ones_like(jd)).prod(-1)
        cJ = torch.ones(m.shape[0], dtype=m.dtype)
    Iz = torch.ones_like(Iw) if z is None else kops.k_vec(global_w1[idx], z, lz, name)
    wr = torch.where(ok, Iz * det, 0.0)
    J = J * wr[:, :, None] * wr[:, None, :]
    mu = torch.where(ok, Iw * Iz * a, 0.0).sum(-1)
    tr = cJ * (Kinv * J).sum((-2, -1))
    quad = cJ * torch.einsum("qi,qij,qj->q", a, J, a)
    return mu, torch.abs(quad - mu * mu + scale * (1 + nugget - tr))


@pytest.mark.parametrize("kind", ["kriging", "linked"])
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("Dz,holes", [(0, False), (1, True)], ids=["plain", "z-holes"])
def test_kernel_arithmetic_gives_the_plain_values(kind, name, Dz, holes):
    """Within 1e-10 of the plain values' size: the same quantities in
    another order (the mean through the last row's substitution, tr(K^-1 J)
    as a sum of K^-1's entries times J's), at blocks of condition up to
    about 1e4."""
    args = _case(kind, name, n=80, M=10, k=16, Dw=2, Dz=Dz, holes=holes, seed=9)
    ref = ENTRY[kind][1](*args)
    out = (_kriging_arith if kind == "kriging" else _linked_arith)(*args)
    for o, r in zip(out, ref):
        assert torch.all((o - r).abs() <= 1e-10 * r.abs().max()), (o - r).abs().max()


def test_wrappers_refuse_a_tensor_off_the_card_before_building(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(cv, "build", no_build)
    monkeypatch.setattr(cv, "_lib", None)
    args = _case("kriging", "sexp", n=20, M=3, k=5, Dw=1, Dz=0)
    with pytest.raises(ValueError, match="unsupported device"):
        cp.gp_vecch_t(*args, jitter=0.0)
    args = _case("linked", "sexp", n=20, M=3, k=5, Dw=1, Dz=0)
    with pytest.raises(ValueError, match="unsupported device"):
        cp.link_gp_vecch_t(*args, jitter=0.0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
#: (n, M, k, Dw, Dz, holes): the cell's calls (kriging m1 = 51, D = 1;
#: linked k = 50, Dw = 1), with -1 lanes and a global input, one row a lane
#: (k = 20), the edge of the two-panel factorisation (kriging k = 31, 32;
#: linked 32, 33) and the gate's last block (64 rows), and the ensemble's
#: scale, M = 8000 at n = 1e5
CARD_CASES = [(2000, 250, 50, 1, 0, False), (2000, 250, 50, 1, 1, True),
              (500, 45, 20, 2, 1, True), (500, 33, 31, 1, 0, False),
              (500, 33, 32, 2, 1, True), (500, 33, 33, 1, 0, True),
              (500, 45, 63, 2, 0, True), (500, 45, 64, 1, 1, False),
              (100_000, 8000, 50, 1, 0, False)]


#: float64 bounds of |K6 - plain| (PERF.md has the measured differences):
#: the means and kriging's variances against the largest plain value; the
#: linked variances against the terms the closed form sums, scale (1 +
#: nugget) + mu^2 a query, by kernel (see the test)
RTOL64 = 1e-9
LINKED_VAR_RTOL64 = {"sexp": 1e-8, "matern2.5": 1e-5}


def _err64(kind, name, args, out, ref):
    """Whether K6's float64 outputs are within the bounds, and the errors."""
    mean_err = float((out[0] - ref[0]).abs().max() / ref[0].abs().max())
    if kind == "kriging":
        var_err = float((out[1] - ref[1]).abs().max() / ref[1].abs().max())
        var_tol = RTOL64
    else:
        terms = args[7] * (1 + args[9]) + ref[0] ** 2
        var_err = float(((out[1] - ref[1]).abs() / terms).max())
        var_tol = LINKED_VAR_RTOL64[name]
    return mean_err <= RTOL64 and var_err <= var_tol, (mean_err, var_err)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["kriging", "linked"])
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_k6_matches_the_plain_version(cuda, kind, name):
    """Float64: the means, and kriging's variances, within 1e-9 of the
    largest plain value (measured: 8e-13).  The kernel factors the same
    blocks with the warp Cholesky of K1-K4 (reciprocal square roots, fused
    multiply-adds, another order of the updates) and takes the mean from the
    substitution's last row.  The linked variance is a sum of terms of about
    scale (1 + nugget) + mu^2 that cancel to a small one (F1 in ROADMAP.md),
    and tr(K^-1 J) adds k^2 products of K^-1's entries, up to 1 / (nugget
    nugget_diag) ~ 2e3 here, with J's: sexp within 1e-8 of those terms
    (measured: 5.3e-10); matern2.5 within 1e-5 (measured: 6.2e-7), since
    its J's closed form cancels polynomial terms to about 1e-3 of their
    size (K5's finding) and so carries some 1e-13 of relative error in
    either version.  Float32: no further from the float64 plain values than
    4 times the float32 plain version is, plus 1e-5 of the size: both round
    the same quantities in float32, in another order."""
    entry, _ = ENTRY[kind]
    plain = vcore.gp_vecch_plain if kind == "kriging" else vcore.link_gp_vecch_plain
    for n, M, k, Dw, Dz, holes in CARD_CASES:
        if kind == "kriging" and k == 64:
            k = 63
        args = _case(kind, name, n, M, k, Dw, Dz if kind == "linked" else 0, holes=holes,
                     seed=n + M + k, device=cuda)
        before = cv.launch_counts()["vecchia_pred_t"]["launches"]
        out = entry(*args)
        torch.cuda.synchronize()
        assert cv.launch_counts()["vecchia_pred_t"]["launches"] == before + 1
        ref = plain(*args)
        assert all(torch.isfinite(r).all() for r in ref)
        ok, err = _err64(kind, name, args, out, ref)
        assert ok, (n, M, k, err)
        args32 = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                       for a in args)
        out32, ref32 = entry(*args32), plain(*args32)
        for o, p, r in zip(out32, ref32, ref):
            e, band = (o.double() - r).abs().max(), (p.double() - r).abs().max()
            assert e <= 4 * band + 1e-5 * r.abs().max(), (n, M, k, float(e), float(band))


@pytest.mark.card
@pytest.mark.parametrize("kind", ["kriging", "linked"])
def test_k6_query_is_the_same_bit_for_bit_whatever_its_call(cuda, kind):
    args = _case(kind, "sexp", 2000, 250, 50, 1, 1 if kind == "linked" else 0, holes=True,
                 seed=4, device=cuda)
    whole = ENTRY[kind][0](*args)
    q_args = (0,) if kind == "kriging" else (0, 1, 2)
    for s, e in ((0, 1), (1, 16), (16, 137), (137, 250)):
        part_args = tuple(a[s:e] if i in q_args or (torch.is_tensor(a) and a.dtype == torch.int64)
                          else a for i, a in enumerate(args))
        part = ENTRY[kind][0](*part_args)
        for p, w in zip(part, whole):
            assert torch.equal(p, w[s:e])


@pytest.mark.card
@pytest.mark.parametrize("kind", ["kriging", "linked"])
def test_k6_block_not_positive_definite_is_nan_and_the_retry_matches(cuda, kind):
    """Two training points at one place with nugget * nugget_diag = -1e-4
    make every block that holds both indefinite: those queries come back
    NaN at extra diagonal 0, as the plain version's, and `read_out` takes
    them from the first rung (3e-4), where the kernel and the plain version
    agree as in `test_k6_matches_the_plain_version`."""
    n = 300
    nd = np.ones(n)
    nd[:2] = -0.1
    args = _case(kind, "sexp", n, 100, 30, 1, 0, seed=5, device=cuda, nd=nd, dup=True)
    entry, _ = ENTRY[kind]
    plain = vcore.gp_vecch_plain if kind == "kriging" else vcore.link_gp_vecch_plain
    NN = args[2 if kind == "kriging" else 5]
    both = ((NN == 0).any(1) & (NN == 1).any(1)).cpu().numpy()
    assert both.any() and not both.all()
    out = entry(*args)
    ref = plain(*args)
    for o, r in zip(out, ref):
        assert np.array_equal(~torch.isfinite(o).cpu().numpy(), both)
        assert np.array_equal(~torch.isfinite(r).cpu().numpy(), both)
    mean, var = read_out(partial(entry, *args), vcore.PRED_JITTER_RUNGS)
    mref, vref = read_out(partial(plain, *args), vcore.PRED_JITTER_RUNGS)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    ok, err = _err64(kind, "sexp", args, [torch.as_tensor(mean), torch.as_tensor(var)],
                     [torch.as_tensor(mref), torch.as_tensor(vref)])
    assert ok, err


@pytest.mark.card
@pytest.mark.parametrize("kind", ["kriging", "linked"])
def test_blocks_above_the_gate_take_the_plain_route_on_the_card(cuda, kind):
    k = 64 if kind == "kriging" else 65
    args = _case(kind, "sexp", 300, 20, k, 1, 0, seed=6, device=cuda)
    tracing.reset("kernel.")
    out = ENTRY[kind][0](*args)
    plain = vcore.gp_vecch_plain if kind == "kriging" else vcore.link_gp_vecch_plain
    ref = plain(*args)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert tracing.totals("kernel.") == {}


@pytest.mark.card
def test_one_request_of_the_cell_system_makes_20_launches(cuda):
    """The lgp_n2000.predict cell's system at its configuration's sizes and
    hyper-parameters (model 1 untrained): a 250-point request runs one
    kriging call (model 1, whose container the imputations share) and 10
    Vecchia linked calls (model 2's layer 1, once an imputation), each one
    K6 launch: 11 launches."""
    rs = np.random.RandomState(0)
    X1 = rs.uniform(-1, 1, (2000, 1))
    X2 = rs.uniform(0, 1, (2000, 1))
    np.random.seed(1)
    g = dt.gp(X1, np.sin(3 * X1), dt.kernel(length=np.array([0.3]), name="matern2.5",
                                            nugget=1e-4, scale_est=True),
              vecchia=True, m=25, device=cuda)
    dt.nb_seed(2)
    m2 = dt.dgp(X2, np.cos(5 * X2), [
        [dt.kernel(length=np.array([0.32003613420970567]), name="sexp", nugget=1e-4)],
        [dt.kernel(length=np.array([0.6134376175883517]), name="sexp",
                   nugget=0.013695808099889633, scale=0.16732681913711653,
                   scale_est=True, nugget_est=True, connect=np.arange(1))]],
        vecchia=True, m=25, device=cuda)
    system = dt.lgp([[dt.container(g.export(), local_input_idx=np.array([0]), device=cuda)],
                     [dt.container(m2.estimate(), local_input_idx=np.array([0]),
                                   device=cuda)]], N=10, device=cuda)
    x = np.linspace(-1, 1, 250)[:, None]
    system.predict(x, m=50)
    torch.cuda.synchronize()
    tracing.reset("kernel.")
    mu, var = system.predict(x, m=50)
    assert np.isfinite(mu[0]).all() and np.isfinite(var[0]).all()
    assert tracing.totals("kernel.launches.K6") == {"kernel.launches.K6": 11,
                                                    f"kernel.launches.K6@{cuda}": 11}
