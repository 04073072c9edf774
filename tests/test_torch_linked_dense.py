"""K5 `linked_dense_t` (`dgp_tpu_torch/ops/cuda_linked.py`), the dense
linked-GP moments, and `gp_core.linkgp_predict` around it.

On the CPU:
1. `gp_core.linkgp_predict` gives, bit for bit, what it gave when it built
   every query's (n, n) moments itself (the code kept below as
   `_linkgp_predict_before`), whole and in batches;
2. the wrapper takes the plain version for CPU tensors and counts no
   launch;
3. the kernel's arithmetic, written out in torch -- the pairs' factors of
   one J per query, matern's deterministic dims folded into the row
   weights (`_kernel_weights`) -- gives the plain version's moments.

The tests marked ``card`` hold the kernel to the plain version on an
NVIDIA card (sexp and matern2.5, D = 1-3, with and without row weights
and zero-variance dims, M = 1, 15, 250, n = 37, 1999, 2000, float64 and
float32), check that a query's values are the same bit for bit whatever
batch it comes in, that a dense call makes one launch, and that a call
holds no (M, n, n) tensor.  This file imports no JAX; on the card:
``python -m pytest tests/test_torch_linked_dense.py -m card --noconftest``.
"""
import numpy as np
import pytest
import torch

from dgp_tpu_torch import gp_core, tracing
from dgp_tpu_torch.ops import cuda_linked as cl
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.ops import kernels, linalg, moments


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _linkgp_predict_before(m, v, z, X, Zglobal, Rinv, Rinv_y, scale, length, nugget,
                           *, name):
    """`gp_core.linkgp_predict` as it was before K5: each batch's (n, n)
    moments built in place."""
    n = X.shape[0]
    per_query = 3 * n * n * (torch.finfo(X.dtype).bits // 8)
    batch = max(1, cl.LINK_BUDGET // per_query)
    if m.shape[0] > batch:
        parts = [_linkgp_predict_before(m[s:s + batch], v[s:s + batch],
                                        None if z is None else z[s:s + batch], X, Zglobal,
                                        Rinv, Rinv_y, scale, length, nugget, name=name)
                 for s in range(0, m.shape[0], batch)]
        return tuple(torch.cat(p) for p in zip(*parts))
    Dw = X.shape[1]
    Dz = 0 if z is None else z.shape[1]
    full_len = torch.broadcast_to(length, (Dw + Dz,))
    length_w, length_z = full_len[:Dw], full_len[Dw:]
    I, J = moments.IJ(X, m, v, length_w, name)
    if z is not None:
        Iz = kernels.k_vec(Zglobal, z, length_z, name)
        I = I * Iz
        J = J * (Iz[:, :, None] * Iz[:, None, :])
    tr = linalg.trace_prod(Rinv, J)
    mu = I @ Rinv_y
    quad = torch.sum((J @ Rinv_y[:, None])[..., 0] * Rinv_y, dim=-1)
    var = torch.abs(quad - mu**2 + scale * (1.0 + nugget - tr))
    return mu, var


def _system(n, D, Dz, M, seed, dtype=torch.float64, device="cpu", zero_var=False):
    """A dense node's (X, Zglobal, Rinv, Rinv_y, length) and M queries (m, v,
    z), made with numpy from ``seed``; with ``zero_var`` every other query
    is deterministic in its first dim."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(0, 1, (n, D))
    Zg = rs.uniform(0, 1, (n, Dz)) if Dz else None
    length = rs.uniform(0.3, 0.6, D + Dz)
    m = rs.uniform(0, 1, (M, D))
    v = rs.uniform(0.001, 0.05, (M, D))
    if zero_var:
        v[::2, 0] = 0.0
    z = rs.uniform(0, 1, (M, Dz)) if Dz else None
    y = np.sin(4 * X.sum(1)) + (np.cos(3 * Zg.sum(1)) if Dz else 0.0)
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float64)
    Xfull = X if Zg is None else np.concatenate([X, Zg], 1)
    Rinv, Rinv_y = gp_core.compute_stats(t(Xfull), t(y), t(length), 1e-4, name="sexp")
    to = lambda a: None if a is None else torch.as_tensor(a).to(dtype=dtype, device=device)
    return (to(X), to(Zg), to(Rinv), to(Rinv_y), to(length), to(m), to(v), to(z))


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("Dz", [0, 1])
@pytest.mark.parametrize("budget_queries", [None, 4])
def test_cpu_route_gives_the_previous_results_bit_for_bit(name, Dz, budget_queries,
                                                          monkeypatch):
    n, M = 30, 11
    X, Zg, Rinv, Rinv_y, length, m, v, z = _system(n, 2, Dz, M, seed=5, zero_var=True)
    if budget_queries:
        monkeypatch.setattr(cl, "LINK_BUDGET", budget_queries * 3 * n * n * 8)
    args = (m, v, z, X, Zg, Rinv, Rinv_y, 0.7, length, 1e-3)
    before = _linkgp_predict_before(*args, name=name)
    after = gp_core.linkgp_predict(*args, name=name)
    assert torch.equal(after[0], before[0]) and torch.equal(after[1], before[1])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    X, _, Rinv, Rinv_y, length, m, v, _ = _system(25, 2, 0, 6, seed=1)
    W = torch.rand((6, 25), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    tracing.reset("kernel.")
    out = cl.linked_dense_t(X, m, v, W, Rinv, Rinv_y, length, name="sexp")
    ref = cl.linked_dense_t_plain(X, m, v, W, Rinv, Rinv_y, length, name="sexp")
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tracing.totals("kernel.") == {}
    assert cv.launch_counts()["linked_dense_t"] == {"launches": 0, "plain_calls": 0}


def _kernel_sums(X, m, v, W, Rinv, a, length, name):
    """K5's arithmetic in torch: the row weights and Iw of `_kernel_weights`,
    J built per query with a factor of 1 for matern's dims of zero variance,
    the sexp factor c_q applied to the sums."""
    Iw, Wj = cl._kernel_weights(X, m, v, W, length, name)
    l = length
    u = X[None, :, :] - m[:, None, :]                       # (M, n, D)
    if name == "sexp":
        p = u[:, :, None, :] + u[:, None, :, :]
        d = u[:, :, None, :] - u[:, None, :, :]
        e = (p * p / (2 * l * l + 8 * v[:, None, None, :]) + d * d / (2 * l * l)).sum(-1)
        J = torch.exp(-e)
        c = torch.prod(1.0 / torch.sqrt(1.0 + 4.0 * v / (l * l)), dim=-1)
    else:
        vs = torch.where(v > 0, v, torch.ones_like(v))[:, None, None, :]
        jd = moments._jd_matern_1d(X[:, None, :], X[None, :, :], m[:, None, None, :], vs, l)
        J = torch.where(v[:, None, None, :] > 0, jd, torch.ones_like(jd)).prod(-1)
        c = torch.ones(m.shape[0], dtype=X.dtype)
    if Wj is not None:
        J = J * Wj[:, :, None] * Wj[:, None, :]
    tr = c * (Rinv * J).sum((-2, -1))
    quad = c * torch.einsum("i,qij,j->q", a, J, a)
    return Iw @ a, tr, quad


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("zero_var", [False, True])
def test_kernel_arithmetic_gives_the_plain_moments(name, zero_var):
    X, Zg, Rinv, Rinv_y, length, m, v, z = _system(40, 2, 1, 9, seed=2, zero_var=zero_var)
    W = kernels.k_vec(Zg, z, length[2:], name)
    ref = cl.linked_dense_t_plain(X, m, v, W, Rinv, Rinv_y, length[:2], name=name)
    out = _kernel_sums(X, m, v, W, Rinv, Rinv_y, length[:2], name)
    absref = cl.linked_dense_t_plain(X, m, v, W, Rinv.abs(), Rinv_y.abs(), length[:2],
                                     name=name)
    for o, r, s in zip(out, ref, absref):
        assert torch.all((o - r).abs() <= 1e-12 * s)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card_case(dev, name, n, D, M, with_w, zero_var, seed):
    X, Zg, Rinv, a, length, m, v, z = _system(n, D, 1 if with_w else 0, M, seed,
                                              device=dev, zero_var=zero_var)
    W = kernels.k_vec(Zg, z, length[D:], name) if with_w else None
    return X, m, v, W, Rinv, a, length[:D].contiguous()


@pytest.mark.card
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("with_w,zero_var", [(False, False), (True, True)],
                         ids=["plain-inputs", "weights-zero-var"])
def test_k5_matches_the_plain_version(cuda, name, D, with_w, zero_var):
    """Float64: within 1e-11 of the sum of the terms' magnitudes (the
    plain version run on |Rinv| and |a|): the kernel adds up to 4e6 terms
    in another order, some 25 roundings deep, and evaluates matern's
    closed form, whose polynomial terms cancel to about 1e-3 of their
    size, with fused multiply-adds.  Float32: no further from the float64
    plain values than 4 times the float32 plain version is, plus 1e-6 of
    the magnitudes: the kernel's float32 sums and exponentials round as
    the plain version's do, in another order."""
    for n, M in ((37, 1), (37, 15), (1999, 15), (2000, 250)):
        args = _card_case(cuda, name, n, D, M, with_w, zero_var, seed=n + M + D)
        X, m, v, W, Rinv, a, length = args
        ref = cl.linked_dense_t_plain(*args, name=name)
        mag = cl.linked_dense_t_plain(X, m, v, W, Rinv.abs(), a.abs(), length, name=name)
        out = cl.linked_dense_t(*args, name=name)
        torch.cuda.synchronize()
        for o, r, s in zip(out, ref, mag):
            assert torch.all((o - r).abs() <= 1e-11 * s), (n, M, (o - r).abs().max().item())
        args32 = [None if t is None else t.float() for t in args]
        out32 = cl.linked_dense_t(*args32, name=name)
        ref32 = cl.linked_dense_t_plain(*args32, name=name)
        for o, p, r, s in zip(out32, ref32, ref, mag):
            err = (o.double() - r).abs().max()
            band = (p.double() - r).abs().max()
            assert err <= 4 * band + 1e-6 * s.max(), (n, M, err.item(), band.item())


@pytest.mark.card
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_k5_query_is_the_same_bit_for_bit_whatever_its_batch(cuda, name):
    X, m, v, W, Rinv, a, length = _card_case(cuda, name, 2000, 2, 250, True, True, seed=7)
    whole = cl.linked_dense_t(X, m, v, W, Rinv, a, length, name=name)
    for s, e in ((0, 1), (1, 16), (16, 137), (137, 250)):
        part = cl.linked_dense_t(X, m[s:e], v[s:e], W[s:e], Rinv, a, length, name=name)
        for p, w in zip(part, whole):
            assert torch.equal(p, w[s:e])


@pytest.mark.card
def test_k5_makes_one_launch_a_dense_call(cuda):
    X, Zg, Rinv, a, length, m, v, z = _system(2000, 2, 0, 250, seed=3, device=cuda)
    gp_core.linkgp_predict(m, v, None, X, None, Rinv, a, 0.7, length, 1e-3, name="sexp")
    torch.cuda.synchronize()
    tracing.reset("kernel.")
    gp_core.linkgp_predict(m, v, None, X, None, Rinv, a, 0.7, length, 1e-3, name="sexp")
    assert tracing.totals("kernel.launches.K5") == {"kernel.launches.K5": 1,
                                                    f"kernel.launches.K5@{cuda}": 1}
    assert cv.launch_counts()["linked_dense_t"] == {"launches": 1, "plain_calls": 0}
    assert cv.launch_counts_by_device()["linked_dense_t"] == {str(cuda): 1}


@pytest.mark.card
def test_k5_holds_no_query_by_pair_tensor(cuda):
    """Peak memory of a 250-query call at n = 2000 above its inputs: within
    8 (M n D + n^2) values, where one (M, n, n) tensor would be 250 n^2."""
    n, D, M = 2000, 2, 250
    X, Zg, Rinv, a, length, m, v, z = _system(n, D, 1, M, seed=4, device=cuda)
    args = (m, v, z, X, Zg, Rinv, a, 0.7, length, 1e-3)
    gp_core.linkgp_predict(*args, name="sexp")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = gp_core.linkgp_predict(*args, name="sexp")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert torch.isfinite(out[1]).all()
    assert peak <= 8 * (M * n * D + n * n) * 8, peak
