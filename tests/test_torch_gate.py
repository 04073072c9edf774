"""The kernel gate of dgp_tpu_torch (`ops.cuda_vecchia.use_kernel`) and the
size check of Vecchia models, on the CPU: the gate's decision from the
kernel's id, the block shape and the dtype alone (blocks of up to 64 rows,
K1 with any number of length lanes up to d, staged tiles within one SM's
shared memory); the shared-memory formula it shares with the CUDA sources;
the wrappers' ``plain_calls`` counters on the CPU and their refusal off it;
Vecchia DGPs inside the bound (m = 12, and m = 40 on two rows per lane) and
outside it (m = 64, through the large-block route of `vecchia.core`) on the
CPU against dgp_tpu at rtol 1e-9; the route's log-likelihood, conditional
weights and M-step group objective at m = 64 and m = 100 against dgp_tpu's
XLA branch, and its arrays at one chunk and at several."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
import dgp_tpu_torch
from dgp_tpu.models import imputation as jimp
from dgp_tpu.models import mstep as jmstep
from dgp_tpu.vecchia import core as jcore
from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models import mstep as tmstep
from dgp_tpu_torch.models.compiled import CompiledDGP, _Shares
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.vecchia import core as vcore
from dgp_tpu_torch.vecchia import nn as vnn

torch.set_num_threads(1)

KIDS = ("K1", "K2", "K3", "K4")


# one row per lane up to m1 = 32, two rows per lane up to 64 (the JAX
# package's kernels take m1 <= 64 too), nothing above
@pytest.mark.parametrize("m1,inside", [(26, True), (32, True), (33, True), (41, True),
                                       (64, True), (65, False)])
@pytest.mark.parametrize("kid", KIDS)
def test_gate_block_bound(kid, m1, inside):
    for dtype in (torch.float64, torch.float32):
        assert cv.use_kernel(kid, m1, 2, dtype=dtype) is inside
        assert cv.use_kernel(kid, m1, 12, dtype) is inside


def test_gate_length_lanes():
    """K1 takes any number of length lanes up to d (in passes of eight):
    on the CPU a call with 9 or 12 lanes is inside the bound, counts no
    plain call and is the plain version; more lanes than dims is an invalid
    call."""
    cv.reset_launch_counts()
    for m1, d, n_length in ((26, 9, 9), (26, 12, 12), (64, 9, 9), (41, 12, 1)):
        assert cv.use_kernel("K1", m1, d)
        X, y, diag = _blocks(m1, d)
        out = cv.block_nllik_grad_parts_t(X, y, diag, 0.1 * diag, name='sexp',
                                          n_length=n_length, nugget_est=True)
        ref = cv.block_nllik_grad_parts_t_plain(X, y, diag, 0.1 * diag, name='sexp',
                                                n_length=n_length, nugget_est=True)
        assert out[2].shape == (n_length + 1, 12)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(c == {"launches": 0, "plain_calls": 0} for c in cv.launch_counts().values())
    X, y, diag = _blocks(26, 12)
    with pytest.raises(ValueError, match="n_length=13"):
        cv.block_nllik_grad_parts_t(X, y, diag, diag, name='sexp', n_length=13,
                                    nugget_est=False)


@pytest.mark.parametrize("kid,dtype,d_last", [
    ("K2", torch.float64, 217), ("K2", torch.float32, 444), ("K1", torch.float64, 868),
    ("K3", torch.float64, 870), ("K4", torch.float64, 871)])
def test_gate_shared_memory_bound(kid, dtype, d_last):
    """At m1 = 32 a one-point thread block fits the SM's 227 KB up to
    d_last dims; wider blocks are outside the gate."""
    assert cv.use_kernel(kid, 32, d_last, dtype=dtype)
    assert not cv.use_kernel(kid, 32, d_last + 1, dtype=dtype)
    assert cv.shared_bytes(kid, 32, d_last, dtype) <= cv.SMEM_MAX \
        < cv.shared_bytes(kid, 32, d_last + 1, dtype)


# the largest d the gate admitted for K2 before its one-row kernel kept the
# static dims' factor, by m1: (float64, float32)
K2_D_LAST = {26: (270, 549), 32: (217, 444), 41: (168, 345), 48: (142, 293),
             64: (104, 218)}


@pytest.mark.parametrize("m1,dtype,d_last", [
    (m1, dtype, d) for m1, per_dtype in K2_D_LAST.items()
    for dtype, d in zip((torch.float64, torch.float32), per_dtype)])
def test_k2_gate_admits_no_fewer_dims(m1, dtype, d_last):
    """K2 still takes every d it took: its shared values are reserved from
    (m1, d) alone, for dl = d, whatever dl a call brings."""
    assert cv.use_kernel("K2", m1, d_last, dtype)


def test_shared_bytes_formula_is_the_sources():
    """The gate's byte count repeats the CUDA sources' per-point formulas
    and constants; the card's run holds it to `launch_plan`'s figure."""
    src = {p.name: " ".join(p.read_text().split()) for p in cv._CSRC.glob("*.cu*")}
    warp = src["vecchia_warp.cuh"]
    assert f"constexpr int WARPS_MAX = {cv._WARPS_MAX};" in warp
    assert f"constexpr int WARP = {cv._WARP};" in warp
    assert "constexpr int LDS = WARP + 1;" in warp
    assert "constexpr int PANEL = WARP * LDS;" in warp
    assert "return m1 <= WARP ? 1 : 2;" in warp
    assert "constexpr size_t SMEM_DEFAULT = 48 * 1024;" in warp
    assert "constexpr int KEEP_NONE = 0, KEEP_L = 1, KEEP_LK = 2;" in warp
    assert ("return R == 1 ? m1 * LDS + 2 * WARP : PANEL + (1 + keep) * (m1 - WARP) * LDS"
            " + 2 * WARP;") in warp
    assert f"#define DGP_M1_MAX {cv.M1_MAX}" in src["vecchia_common.cuh"]
    assert "return m1 * d + 3 * m1 + grad_warp_scratch<R>(m1);" in src["block_nllik_grad.cu"]
    assert ("return block_scratch<R>(m1, KEEP_LK) + (R == 1 ? 2 * WARP : 0);"
            in src["block_nllik_grad.cu"])
    assert "return 3 * m1 * d + 2 * m1 + d * m1 + block_scratch<R>(m1, KEEP_NONE);" \
        in src["block_loglik_multi.cu"]
    assert "return m1 * d + m1 + (m1 - 1) + condw_warp_scratch<R>(m1);" \
        in src["cond_weights.cu"]
    assert "return block_scratch<R>(m1, KEEP_L) + (R == 1 ? WARP : 0);" in src["cond_weights.cu"]
    assert "return m1 * d + 2 * m1 + block_scratch<R>(m1, KEEP_NONE);" \
        in src["block_loglik_parts.cu"]
    # the main path's blocks in float64: 4 points of a thread block, below
    # the default of 48 KB
    assert cv.shared_bytes("K4", 26, 2, torch.float64) == 4 * 8 * (26 * 2 + 52 + 26 * 33 + 64)
    assert cv.shared_bytes("K2", 26, 2, torch.float64) == 37824
    # m = 40: two points of a thread block, each with a (32, 33) array,
    # L11's (9, 33) and two column buffers (K4 keeps no L21)
    assert cv.shared_bytes("K4", 41, 2, torch.float64) == \
        2 * 8 * (41 * 2 + 82 + 32 * 33 + 9 * 33 + 64)


def _blocks(m1, d, n=12, seed=0):
    rs = np.random.RandomState(seed)
    X = torch.as_tensor(rs.uniform(-2, 2, (m1, d, n)))
    y = torch.as_tensor(rs.uniform(-1, 1, (m1, n)))
    diag = torch.full((m1, n), 1.1, dtype=torch.float64)
    return X, y, diag


# the last d inside the gate with two rows per lane, beside the last d of
# the design before the two-panel factorisation (blocks of (m1, 65) values):
# (m1, kid) -> (float64, float32) of each
TWO_ROW_D_LAST = {
    (33, "K1"): ((840, 808), (1721, 1689)), (48, "K1"): ((546, 534), (1151, 1140)),
    (64, "K1"): ((384, 384), (838, 838)),
    (33, "K2"): ((210, 203), (431, 423)), (48, "K2"): ((142, 134), (293, 285)),
    (64, "K2"): ((104, 96), (218, 210)),
    (33, "K3"): ((842, 811), (1723, 1692)), (48, "K3"): ((558, 537), (1163, 1142)),
    (64, "K3"): ((401, 386), (855, 840)),
    (33, "K4"): ((843, 813), (1724, 1693)), (48, "K4"): ((569, 538), (1174, 1143)),
    (64, "K4"): ((418, 387), (872, 841)),
}


@pytest.mark.parametrize("m1,kid,dtype,d_last,d_before", [
    (m1, kid, dtype, *dims) for (m1, kid), per_dtype in TWO_ROW_D_LAST.items()
    for dtype, dims in zip((torch.float64, torch.float32), per_dtype)])
def test_gate_shared_memory_bound_two_rows_per_lane(m1, kid, dtype, d_last, d_before):
    """With two rows per lane a warp keeps a (32, 33) array, L11's (m1 -
    32, 33) and two column buffers, K1 and K3 also L21's (m1 - 32, 33) and
    K1 a copy of A21 of that size: a one-point thread block fits the SM's
    227 KB up to d_last dims, no fewer than the design that kept an (m1,
    65) array (d_before: at m1 = 64 in float64 K2 96, K1 384, K3 386, K4
    387)."""
    assert d_last >= d_before
    assert cv.use_kernel(kid, m1, d_last, dtype)
    assert not cv.use_kernel(kid, m1, d_last + 1, dtype)


def test_wrappers_count_plain_calls_only_outside_the_bound():
    cv.reset_launch_counts()
    X, y, diag = _blocks(9, 2)
    cv.block_loglik_parts_t(X, y, diag, name='sexp')
    cv.cond_weights_t(X, diag, name='sexp')
    assert all(c == {"launches": 0, "plain_calls": 0} for c in cv.launch_counts().values())
    X, y, diag = _blocks(65, 2)
    ld, q = cv.block_loglik_parts_t(X, y, diag, name='sexp')
    ref = cv.block_loglik_parts_t_plain(X, y, diag, name='sexp')
    np.testing.assert_array_equal(ld.numpy(), ref[0].numpy())
    cv.cond_weights_t(X, diag, name='sexp')
    cv.block_loglik_multi_t(X, X, X, y, diag, [1.0, 0.5], [0.0, 0.5], name='sexp')
    cv.block_nllik_grad_parts_t(X, y, diag, 0.1 * diag, name='sexp', n_length=2,
                                nugget_est=True)
    counts = cv.launch_counts()
    assert all(counts[k] == {"launches": 0, "plain_calls": 1} for k in cv.KERNEL_ID)
    # K5 (cuda_linked) has no bound: the views list it, with no plain calls
    assert counts["linked_dense_t"] == {"launches": 0, "plain_calls": 0}
    cv.reset_launch_counts()
    assert all(c["plain_calls"] == 0 for c in cv.launch_counts().values())


def test_wrappers_refuse_blocks_outside_the_bound_off_the_cpu(monkeypatch):
    """Off the CPU no plain version stands in for a kernel: a call outside
    the bound raises before anything is built, and counts nothing."""
    monkeypatch.setattr(cv, "build", lambda: pytest.fail("the kernel library was built"))
    monkeypatch.setattr(cv, "_lib", None)
    cv.reset_launch_counts()
    X, y, diag = (t.to('meta') for t in _blocks(65, 2))
    for call in (lambda: cv.block_loglik_parts_t(X, y, diag, name='sexp'),
                 lambda: cv.cond_weights_t(X, diag, name='sexp'),
                 lambda: cv.block_loglik_multi_t(X, X, X, y, diag, [1.0], [0.0], name='sexp'),
                 lambda: cv.block_nllik_grad_parts_t(X, y, diag, diag, name='sexp',
                                                     n_length=2, nugget_est=True)):
        with pytest.raises(NotImplementedError, match="m1=65 rows.*device='cpu'"):
            call()
    wide = torch.empty((32, 218, 4), device='meta', dtype=torch.float64)
    v = torch.empty((32, 4), device='meta', dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="shared memory"):
        cv.block_loglik_multi_t(wide, wide, wide, v, v, [1.0], [0.0], name='sexp')
    assert all(c == {"launches": 0, "plain_calls": 0} for c in cv.launch_counts().values())


def _func(x):
    return np.sin(6 * x) + 0.5 * np.cos(11 * x)


def _layers(pkg):
    return pkg.combine([pkg.kernel(length=np.array([0.5]), nugget=1e-3)],
                       [pkg.kernel(length=np.array([0.5]), nugget=1e-3, nugget_est=True,
                                   scale_est=True, connect=np.arange(1))])


def _jax_model(X, Y, m):
    """A dgp_tpu Vecchia DGP without its compiled initial imputation."""
    dgp_tpu.nb_seed(0)
    sample = jimp.imputer.sample
    jimp.imputer.sample = lambda self, burnin=0: None
    try:
        return dgp_tpu.dgp(X, Y, _layers(dgp_tpu), vecchia=True, m=m)
    finally:
        jimp.imputer.sample = sample


@pytest.mark.parametrize("m,inside", [(40, True), (64, False), (12, True)])
def test_vecchia_dgp_outside_the_bound_matches_jax(m, inside):
    """On the CPU a Vecchia DGP at m = 64 runs (the callers send its blocks
    down the large-block route, as on the card) and its log-likelihoods
    agree with dgp_tpu's; at m = 12 and at m = 40 (two rows per lane on the
    card) the route is not taken, and the angle evaluator applies.  No
    wrapper is called outside its bound either way."""
    rs = np.random.RandomState(0)
    X = rs.rand(90, 1) * 2 - 1
    Y = _func(X) + 0.05 * rs.randn(90, 1)
    mj = _jax_model(X, Y, m)
    eng_j = mj.imp._engine()
    eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(mj.all_layer)), device='cpu')
    assert eng_t._angle_applicable(0) is inside
    assert cv.use_kernel("K2", m + 1, 2) is inside
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state()
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    cv.reset_launch_counts()
    vcore.reset_route_counts()
    ref = jax.jit(lambda lat: eng_j._upper_loglik(0, (lat,), par_j, nn_j))
    cands = np.asarray(lat_j[0])[None] + 0.1 * rs.normal(size=(3,) + tuple(lat_t[0].shape))
    out = eng_t._upper_loglik(0, (torch.as_tensor(cands),), par_t, nn_t)
    np.testing.assert_allclose(out.numpy(), [float(ref(jnp.asarray(c))) for c in cands],
                               rtol=1e-9)
    assert vcore.route_counts()["K4"] == (0 if inside else 1)
    # the whole path on the port: imputation, SEM iterations, prediction
    dgp_tpu_torch.nb_seed(0)
    cv.reset_launch_counts()
    vcore.reset_route_counts()
    mt = dgp_tpu_torch.dgp(X, Y, _layers(dgp_tpu_torch), vecchia=True, m=m, device='cpu')
    mt.train(N=3, disable=True)
    mu, var = dgp_tpu_torch.emulator(mt.estimate(), N=2, device='cpu').predict(
        np.linspace(-1, 1, 20)[:, None], m=50)
    assert np.isfinite(mu).all() and np.isfinite(var).all()
    counts = cv.launch_counts()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in counts.values())
    routes = vcore.route_counts()
    if inside:
        assert all(v == 0 for v in routes.values())
    else:
        assert all(routes[k] > 0 for k in ("K1", "K3", "K4"))


def _route_inputs(m, n=150, d=2, seed=3):
    """Float64 inputs of one Vecchia node at m neighbours: ordered inputs,
    targets, the exact ordered NN array, replicate-like nugget weights."""
    rs = np.random.RandomState(seed)
    X = rs.rand(n, d)
    y = np.sin(4 * X).sum(axis=1) + 0.05 * rs.randn(n)
    NN = vnn.nn(X / 0.4, m, device='cpu')
    nd = 1.0 + rs.rand(n)
    return X, y, NN, nd


@pytest.mark.parametrize("m,name", [(64, "sexp"), (100, "sexp"), (64, "matern2.5")])
def test_route_matches_jax_xla_branch(m, name):
    """Outside the kernels' bound the route's log-likelihood (alone and for
    two candidate inputs) and conditional weights equal dgp_tpu's XLA branch
    on the same float64 inputs at rtol 1e-9.  The JAX side is jitted: its
    column-unrolled factor costs minutes op by op."""
    X, y, NN, nd = _route_inputs(m)
    assert not any(cv.use_kernel(k, m + 1, 2) for k in ("K1", "K3", "K4"))
    length, nugget, scale = np.array([0.4, 0.7]), 1e-3, 1.3
    T, J = torch.as_tensor, jnp.asarray
    cands = np.stack([X, X[::-1] * 0.9])
    vcore.reset_route_counts()
    ll = vcore.vecchia_llik(T(X), T(y), T(NN), scale, T(length), nugget, T(nd), name)
    llk = vcore.vecchia_llik(T(cands), T(y), T(NN), scale, T(length), nugget, T(nd), name)
    w, sigma, idx, _ = vcore.cond_weights(T(X), T(NN), T(length), nugget, name, T(nd))
    assert vcore.route_counts() == {"K1": 0, "K3": 1, "K4": 2}
    llik_j = jax.jit(lambda Xc: jcore.vecchia_llik(Xc, J(y), J(NN), scale, J(length),
                                                   nugget, J(nd), name))
    np.testing.assert_allclose(float(ll), float(llik_j(J(X))), rtol=1e-9)
    np.testing.assert_allclose(llk.numpy(), [float(llik_j(J(c))) for c in cands],
                               rtol=1e-9)
    wj, sj, ij, _ = jax.jit(lambda Xc: jcore.cond_weights(Xc, J(NN), J(length), nugget,
                                                          name, J(nd)))(J(X))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sj), rtol=1e-9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))


@pytest.mark.parametrize("m", [64, 100])
def test_route_m_step_group_matches_jax(m):
    """One M-step group of both layers' nodes at blocks of m + 1 rows, at
    the starting parameters and at a shifted point: the route's objective
    equals dgp_tpu's `_vecch_nll_xla` at rtol 1e-9 and its gradient the
    autodiff gradient at rtol 1e-7; `run_group` takes the route."""
    rs = np.random.RandomState(1)
    X = rs.rand(130, 1) * 2 - 1
    Y = _func(X) + 0.05 * rs.randn(130, 1)
    mj = _jax_model(X, Y, m)
    eng_j = mj.imp._engine()
    eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(mj.all_layer)), device='cpu')
    (lat_j, par_j), nn_j = eng_j.get_state(), eng_j.get_nn_state()
    (lat_t, par_t), nn_t = eng_t.get_state(), eng_t.get_nn_state()
    cs_j = eng_j._chunk_static(nn_j)
    es = [(0, 0), (1, 0)]
    d_max = max(eng_t.spec[l][k].D for l, k in es)
    p_max = max(eng_t.spec[l][k].n_length + eng_t.spec[l][k].nugget_est for l, k in es)
    built = [eng_t._node_operands(l, k, eng_t.spec[l][k], lat_t, par_t, d_max, p_max)
             for l, k in es]
    shares = _Shares(eng_t, nn_t)
    shares.sync(lat_t, par_t)
    parts = eng_t._group_blocks([(l, k, eng_t.spec[l][k]) for l, k in es], d_max, shares)
    ops = {key: torch.stack([b[0][key] for b in built]) for key in built[0][0]}
    lt0 = torch.stack([b[1] for b in built])
    ops_j = [eng_j._node_operands(l, k, eng_j.spec[l][k], lat_j, par_j, nn_j, d_max,
                                  p_max, "vecch", cs_j)[0] for l, k in es]
    fg_j = jax.jit(jax.value_and_grad(
        lambda t, op: jmstep._vecch_nll_xla(t, op, name='sexp', n=eng_j.n), has_aux=True))
    for shift in (0.0, 0.3):
        lt = lt0 + shift * (torch.stack([b[2] for b in built]) != 0)
        vcore.reset_route_counts()
        nll, g, _ = tmstep._vecch_fg(lt, ops, parts, shares.split, name='sexp',
                                     d_max=d_max, n=eng_t.n, has_ref=False, route=True)
        assert vcore.route_counts()["K1"] == 1
        for i in range(len(es)):
            (ref, _), gj = fg_j(jnp.asarray(lt[i].numpy()), ops_j[i])
            np.testing.assert_allclose(float(nll[i]), float(ref), rtol=1e-9)
            np.testing.assert_allclose(g[i].numpy(), np.asarray(gj), rtol=1e-7, atol=1e-9)
    vcore.reset_route_counts()
    tmstep.run_group(ops, lt0, torch.stack([b[2] for b in built]),
                     torch.stack([b[3] for b in built]), [2, 2], name='sexp',
                     mode='vecch', d_max=d_max, n=eng_t.n, has_ref=False, parts=parts,
                     split=shares.split)
    assert vcore.route_counts()["K1"] == 2


def test_route_arrays_do_not_depend_on_the_chunk(monkeypatch):
    """Each route gives the same arrays in one chunk and in chunks of 7
    points (a ragged last chunk), K1's gradients included."""
    m = 70
    X, y, NN, nd = _route_inputs(m, n=40)
    T = torch.as_tensor
    Xt, yt, NNt, ndt = T(X), T(y), T(NN), T(nd)
    length = T(np.array([0.4, 0.7]))
    lanes = torch.log(T(np.array([0.4, 0.7, 1e-3])))
    raw = cv.gather_raw_t(Xt, yt, NNt, ndt)

    def run():
        parts = vcore._llik_route(torch.stack([Xt, 0.9 * Xt]), yt, NNt, length, 1e-3,
                                  ndt, 'matern2.5')
        parts += vcore._cond_weights_route(Xt, NNt, length, 1e-3, 'sexp', ndt)
        parts += vcore.nllik_grad_route(*raw, lanes, lambda lt: (torch.exp(lt[..., :-1]),
                                                                 torch.exp(lt[..., -1])),
                                        'sexp')
        return parts

    one = run()
    per_point = 2 * (8 + 4 * 2) * (m + 1) ** 2 * 8
    monkeypatch.setattr(vcore, "ROUTE_BUDGET", 7 * per_point)
    assert vcore._route_step(2, m + 1, 2, torch.float64) == 7
    several = run()
    for a, b in zip(one, several):
        assert torch.isfinite(a).all()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
