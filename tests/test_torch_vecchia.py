"""dgp_tpu_torch.vecchia and the plain versions of the CUDA kernels against
dgp_tpu: neighbour sets (exactly), conditional weights (against both the
XLA branch and the Pallas kernel in interpret mode), ancestral sampling
with the same noise, Vecchia GP and linked-GP prediction, the K2 candidate
evaluator, the K4 per-point parts, the K3 weights on given blocks and
the K1 analytic gradient (each against its Pallas kernel in interpret
mode), and the K1 objective against torch autograd of the port's own
reference form; the cases of all four include the edges of the warp
kernels' mapping (m1 = 32 and 2, ragged n, d = 5; K = 1 and dl = 0 for K2;
candidates with their own targets and diagonals for K4); blocks of two
rows per lane and K1 with more than 8 length lanes are in
tests/test_torch_two_rows.py.  Also: shapes beyond
the kernels' bounds go to the plain versions before any build, and the
library's tag covers every source under csrc/.  Tolerances rtol 1e-9, atol 1e-12 for values and rtol
1e-7, atol 1e-10 for gradients, as in tests/test_pallas.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgp_tpu.ops import pallas_vecchia as pv
from dgp_tpu.vecchia import core as jcore
from dgp_tpu.vecchia import nn as jnn
import dgp_tpu_torch as tp
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.vecchia import core as tcore
from dgp_tpu_torch.vecchia import nn as tnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jit(f, *static):
    """The JAX reference, jitted: eager dispatch of its unrolled loops
    costs seconds per call on the CPU."""
    return jax.jit(f, static_argnames=static)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def _setup(n=90, d=2, m=9, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + X[:, -1]
    NN = jnn.nn(X, m)
    return X, y, np.asarray(NN)


def test_nn_index_sets_match():
    rs = np.random.RandomState(1)
    X = rs.uniform(size=(300, 2))
    np.testing.assert_array_equal(tnn.nn(X, 12, device='cpu'), np.asarray(jnn.nn(X, 12)))
    Q = rs.uniform(size=(70, 2))
    np.testing.assert_array_equal(tnn.get_pred_nn(Q, X, 15, device='cpu'),
                                  np.asarray(jnn.get_pred_nn(Q, X, 15)))


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_cond_weights_match_xla_and_pallas(name, monkeypatch):
    X, _, NN = _setup(seed=7)
    length, nugget = np.array([0.5, 0.8]), 1e-3
    w_t, s_t, i_t, v_t = tcore.cond_weights(_t(X), _t(NN), _t(length), nugget, name)
    ref_xla = _jit(jcore.cond_weights, 'name')(jnp.asarray(X), jnp.asarray(NN),
                                               jnp.asarray(length), nugget, name=name)
    monkeypatch.setattr(pv, "use_pallas", lambda *a: True)
    ref_pl = _jit(jcore.cond_weights, 'name')(jnp.asarray(X), jnp.asarray(NN),
                                              jnp.asarray(length), nugget, name=name)
    for ref in (ref_xla, ref_pl):
        _close(w_t, ref[0])
        _close(s_t, ref[1])
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(ref[3]))


def test_cond_weights_pre_gathered_path():
    """The I-step's pre-gathered layer-0 blocks (CompiledDGP._chunk_static,
    through the engine's one share) give the same prior draws as gathering
    the blocks in cond_weights."""
    X, y, _ = _setup(n=60, d=1, seed=8)
    tp.nb_seed(0)
    layers = tp.combine([tp.kernel(length=np.array([0.5]), nugget=1e-3)],
                        [tp.kernel(length=np.array([0.5]))])
    eng = tp.dgp(X, y[:, None], layers, vecchia=True, m=9,
                 device='cpu').imp._engine()
    lat, par = eng.get_state()
    nn_state = eng.get_nn_state()
    draws = eng._draw_prior_node_batch(0, 0, lat, par, nn_state,
                                       torch.Generator().manual_seed(1), 3)
    ns, p = nn_state[0][0], par[0][0]
    w, sigma, idx_asc, _ = tcore.cond_weights(eng._node_input(0, 0, lat)[ns['ord']],
                                              ns['NN'], p['length'], p['nugget'],
                                              eng.spec[0][0].name)
    eps = (torch.randn((3, len(X)), generator=torch.Generator().manual_seed(1),
                       dtype=w.dtype) * torch.sqrt(p['scale']) * sigma[None, :])
    gathered = tcore.ancestral_sample(eps, w, idx_asc)[:, ns['rev']]
    np.testing.assert_array_equal(draws.numpy(), gathered.numpy())


def test_ancestral_sample_same_eps():
    X, _, NN = _setup(n=300, d=1, m=8, seed=2)
    length, nugget = np.array([0.3]), 1e-4
    w, sigma, idx, _ = _jit(jcore.cond_weights, 'name')(
        jnp.asarray(X), jnp.asarray(NN), jnp.asarray(length), nugget, name='sexp')
    eps = np.random.RandomState(3).normal(size=(3, 300)) * np.asarray(sigma)[None]
    ref = _jit(jcore.ancestral_sample, 'block')(jnp.asarray(eps), w, idx)
    out = tcore.ancestral_sample(_t(eps), _t(w), _t(idx))
    _close(out, ref, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_vecchia_llik_matches(name):
    X, y, NN = _setup(seed=4)
    length, nugget, scale = np.array([0.4, 0.7]), 1e-3, 1.3
    nd = np.ones(X.shape[0])
    _close(tcore.vecchia_llik(_t(X), _t(y), _t(NN), scale, _t(length), nugget,
                              _t(nd), name),
           _jit(jcore.vecchia_llik, 'name')(jnp.asarray(X), jnp.asarray(y),
                                            jnp.asarray(NN), scale, jnp.asarray(length),
                                            nugget, jnp.asarray(nd), name=name))


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_gp_and_link_gp_prediction_match(name):
    rs = np.random.RandomState(5)
    n, M, mp = 120, 40, 10
    W = rs.uniform(-1, 1, (n, 1))
    G = rs.uniform(-1, 1, (n, 1))
    y = np.sin(3 * W[:, 0]) + G[:, 0]
    nd = rs.uniform(0.5, 1.0, n)
    length = np.array([0.5, 0.8])
    scale, nugget = 1.4, 1e-3
    x = rs.uniform(-1, 1, (M, 2))
    NN = np.array(jnn.get_pred_nn(x / length, np.hstack([W, G]) / length, mp))
    NN[3, -2:] = -1  # padded conditioning lanes
    WG = np.hstack([W, G])
    _close(tcore.gp_vecch(_t(x), _t(WG), _t(NN), _t(y), scale, _t(length), nugget,
                          _t(nd), name),
           _jit(jcore.gp_vecch, 'name')(jnp.asarray(x), jnp.asarray(WG), jnp.asarray(NN),
                                        jnp.asarray(y), scale, jnp.asarray(length),
                                        nugget, jnp.asarray(nd), name=name))
    mq = rs.uniform(-1, 1, (M, 1))
    vq = rs.uniform(0.01, 0.1, (M, 1))
    z = rs.uniform(-1, 1, (M, 1))
    for zz, gw, ln in ((z, G, length), (None, None, length[:1])):
        w1 = W
        t_out = tcore.link_gp_vecch(_t(mq), _t(vq), None if zz is None else _t(zz),
                                    _t(w1), None if gw is None else _t(gw), _t(NN),
                                    _t(y), scale, _t(ln), nugget, _t(nd), name)
        # eager: XLA's fusion under jit rewrites the Matern moment algebra,
        # whose cancellations then differ from the op-by-op form at ~1e-8
        j_out = jcore.link_gp_vecch(
            jnp.asarray(mq), jnp.asarray(vq), None if zz is None else jnp.asarray(zz),
            jnp.asarray(w1), None if gw is None else jnp.asarray(gw),
            jnp.asarray(NN), jnp.asarray(y), scale, jnp.asarray(ln), nugget,
            jnp.asarray(nd), name=name)
        for a, b in zip(t_out, j_out):
            _close(a, b)


def _multi_inputs(dl, dg, seed=11, m1=6, n=300, K=7):
    """Candidate views like CompiledDGP._build_angle_plan's, with
    sentinel-encoded invalid lanes (mirrors test_pallas.py)."""
    rs = np.random.RandomState(seed)
    d = dl + dg
    A = np.zeros((m1, d, n))
    B = np.zeros((m1, d, n))
    A[:, :dl] = rs.uniform(-1, 1, (m1, dl, n))
    B[:, :dl] = rs.uniform(-1, 1, (m1, dl, n))
    C = np.zeros((m1, d, n))
    C[:, dl:] = rs.uniform(-1, 1, (m1, dg, n))
    valid = rs.uniform(size=(m1, n)) > 0.15
    valid[-1] = True
    sent = 1e7 + rs.uniform(0, 1e3, (m1, n))
    for t in range(d):
        C[:, t] = np.where(valid, C[:, t], sent)
        A[:, t] = np.where(valid, A[:, t], 0.0)
        B[:, t] = np.where(valid, B[:, t], 0.0)
    yg = np.where(valid, rs.uniform(-1, 1, (m1, n)), 0.0)
    diag = np.where(valid, 1.0 + 1e-3, 1.0)
    ang = np.linspace(0.1, 2 * np.pi, K)
    return A, B, C, yg, diag, np.cos(ang), np.sin(ang)


# (dl, dg, m1, n, K): the slice's two layouts, then the edges of the warp
# kernel's mapping: a full warp (m1 = 32) at a ragged n, a two-row block
# with one candidate, no static dims (dl = 0: every dim is built from the
# candidate), two latent and three static dims with an even K (every
# candidate factored beside another), the d = 3 timed row (one latent dim,
# two static), and one candidate alone
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("dl,dg,m1,n,K", [(1, 1, 6, 300, 7), (2, 0, 6, 300, 7),
                                          (1, 1, 32, 301, 3), (2, 0, 2, 37, 1),
                                          (0, 2, 6, 300, 7), (2, 3, 26, 301, 2),
                                          (1, 2, 26, 300, 9), (1, 1, 26, 300, 1)],
                         ids=["1-1", "2-0", "1-1-m32-n301-K3", "2-0-m2-n37-K1", "0-2",
                              "2-3-m26-n301-K2", "1-2-m26-K9", "1-1-m26-K1"])
def test_block_loglik_multi_plain_matches_pallas(name, dl, dg, m1, n, K):
    args = _multi_inputs(dl, dg, m1=m1, n=n, K=K)
    ld_t, q_t = cv.block_loglik_multi_t(*(_t(a) for a in args), name=name, dl=dl)
    ld_j, q_j = pv.block_loglik_multi_t(*(jnp.asarray(a) for a in args), name=name,
                                        dl=dl)
    _close(ld_t, ld_j)
    _close(q_t, q_j)
    assert cv.launch_counts()["block_loglik_multi_t"]["launches"] == 0  # CPU: plain version


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never moved."""
    X = torch.empty((4, 1, 8), device='meta', dtype=torch.float64)
    d = torch.empty((4, 8), device='meta', dtype=torch.float64)
    with pytest.raises(ValueError):
        cv.cond_weights_t(X, d, name='sexp')
    with pytest.raises(ValueError):
        cv.block_loglik_multi_t(X, X, X, d, d, [1.0], [0.0], name='sexp')
    with pytest.raises(ValueError):
        cv.block_loglik_parts_t(X, d, d, name='sexp')
    with pytest.raises(ValueError):
        cv.block_nllik_grad_parts_t(X, d, d, d, name='sexp', n_length=1,
                                    nugget_est=True)


def _meta(*shape):
    return torch.empty(shape, device='meta', dtype=torch.float64)


@pytest.mark.parametrize("case", ["K1-m1", "K2-m1", "K3-m1", "K4-m1", "K1-nlen-max",
                                  "K1-nlen-d"])
def test_kernel_wrappers_refuse_unsupported_shapes_before_build(case, monkeypatch):
    """Shapes beyond the kernels' bounds (m1 > M1_MAX = 64; K1 with a length
    lane per dim at a d whose tiles exceed the SM's shared memory) are the
    gate's decision: off the CPU they are refused, and on the CPU they reach
    the plain version, counted in ``plain_calls``; no library is built or
    loaded either way.  More length lanes than dims is an invalid call and
    raises, also before any build."""
    def no_build(*a, **k):
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(cv, "build", no_build)
    monkeypatch.setattr(cv, "_lib", None)
    reached = []
    for w in cv.WRAPPERS:
        monkeypatch.setattr(cv, w.__name__ + "_plain",
                            lambda *a, _n=w.__name__, **k: reached.append(_n))
    cv.reset_launch_counts()
    # K1 at m1 = 32 takes d <= 868 in float64: 869 lanes lie beyond it
    m1 = cv.M1_MAX + 1 if case.endswith("m1") else (32 if case == "K1-nlen-max" else 8)
    d = 869 if case == "K1-nlen-max" else 2
    n_length = {"K1-nlen-max": 869, "K1-nlen-d": 3}.get(case, 2)
    X, v = _meta(m1, d, 16), _meta(m1, 16)
    calls = {
        "K1": lambda: cv.block_nllik_grad_parts_t(X, v, v, v, name='sexp',
                                                  n_length=n_length, nugget_est=True),
        "K2": lambda: cv.block_loglik_multi_t(X, X, X, v, v, [1.0], [0.0], name='sexp'),
        "K3": lambda: cv.cond_weights_t(X, v, name='sexp'),
        "K4": lambda: cv.block_loglik_parts_t(X, v, v, name='sexp'),
    }
    if case == "K1-nlen-d":
        with pytest.raises(ValueError, match="n_length"):
            calls["K1"]()
        assert reached == []
        return
    with pytest.raises(NotImplementedError, match="outside the hand kernel's bound"):
        calls[case[:2]]()
    assert reached == [] and not any(c["plain_calls"] for c in cv.launch_counts().values())
    X, v = torch.zeros((m1, d, 16), dtype=torch.float64), torch.zeros((m1, 16),
                                                                      dtype=torch.float64)
    calls[case[:2]]()
    wrapper = next(w for w in cv.WRAPPERS if cv.KERNEL_ID[w.__name__] == case[:2])
    assert reached == [wrapper.__name__]
    counts = cv.launch_counts()
    assert counts[wrapper.__name__] == {"launches": 0, "plain_calls": 1}
    assert sum(c["plain_calls"] for c in counts.values()) == 1


def test_build_tag_covers_every_source(tmp_path, monkeypatch):
    """The library's tag changes when any source or header under csrc/
    changes and when a file is added; nothing is built."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cv._CSRC, csrc)
    monkeypatch.setattr(cv, "_CSRC", csrc)
    base = cv._source_hash()
    files = sorted(csrc.glob("*.cu*"))
    assert {f.suffix for f in files} == {".cu", ".cuh"}
    for f in files:
        text = f.read_text()
        f.write_text(text + "\n// edit\n")
        assert cv._source_hash() != base, f.name
        f.write_text(text)
        assert cv._source_hash() == base
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cv._source_hash() != base
    (csrc / "extra.cuh").unlink()
    assert cv._source_hash() == base


def _grad_blocks(n_length, seed, n=70, m=9, d=2):
    """K1 inputs from a real NN structure (its first rows have padded,
    sentinel-encoded lanes), built by the JAX package's own gather and
    per-evaluation transform."""
    X, y, NN = _setup(n=n, d=d, m=m, seed=seed)
    nd = np.random.RandomState(seed).uniform(0.5, 1.0, X.shape[0])
    length = (np.array([0.5]) if n_length == 1 else np.linspace(0.5, 0.8, d)) * (1 + 0.3 * seed)
    nugget = 2e-3 * (1 + seed)
    raw = pv.gather_raw_t(jnp.asarray(X), jnp.asarray(y), jnp.asarray(NN),
                          jnp.asarray(nd))
    full_len = np.broadcast_to(length, (d,))
    Xg, diag, dnug = pv.scale_blocks_t(raw[0], raw[2], raw[3], jnp.asarray(full_len),
                                       nugget, 0.0)
    return tuple(np.asarray(a) for a in (Xg, raw[1], diag, dnug))


# (nugget_est, n_length, (n, m, d)): the four lane layouts at the default
# shape, then the edges of the warp kernel's mapping: a full warp (m1 = 32)
# at a ragged n, a two-row block, and five dims each with its own lane
@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("nugget_est,n_length,shape",
                         [(True, 1, (70, 9, 2)), (True, 2, (70, 9, 2)),
                          (False, 1, (70, 9, 2)), (False, 2, (70, 9, 2)),
                          (True, 2, (71, 31, 2)), (True, 2, (37, 1, 2)),
                          (True, 5, (70, 9, 5))],
                         ids=["True-1", "True-2", "False-1", "False-2", "True-2-m32-n71",
                              "True-2-m2-n37", "True-5-d5"])
def test_block_nllik_grad_plain_matches_pallas(name, n_length, nugget_est, shape):
    """K1's plain version against the Pallas gradient kernel, with a
    leading node axis of two parameter settings (one launch on the card)."""
    groups = [_grad_blocks(n_length, seed, *shape) for seed in (0, 1)]
    kw = dict(name=name, n_length=n_length, nugget_est=nugget_est)
    stacked = [_t(np.stack([g[i] for g in groups])) for i in range(4)]
    out_t = cv.block_nllik_grad_parts_t(*stacked, **kw)
    ref = _jit(pv.block_nllik_grad_parts_t, 'name', 'n_length', 'nugget_est')
    for gi, g in enumerate(groups):
        out_j = ref(*(jnp.asarray(a) for a in g), **kw)
        _close(out_t[0][gi], out_j[0])                      # logdet
        _close(out_t[1][gi], out_j[1])                      # quad
        for a, b in zip(out_t[2:], out_j[2:]):              # gradients
            _close(a[gi], b, rtol=1e-7, atol=1e-10)
    assert cv.launch_counts()["block_nllik_grad_parts_t"]["launches"] == 0  # CPU: plain version


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_block_loglik_parts_plain_matches_pallas(name):
    """K4's plain version against the Pallas kernel, alone and with a
    leading candidate axis whose blocks share one target and diagonal."""
    X, y, NN = _setup(seed=6)
    length, nugget = np.array([0.4, 0.7]), 1e-3
    nd = np.ones(X.shape[0])
    rs = np.random.RandomState(6)
    Xs = [X, X + 0.05 * rs.normal(size=X.shape)]
    blocks = [pv.gather_scale_t(jnp.asarray(Xc), jnp.asarray(y), jnp.asarray(NN),
                                jnp.asarray(length), nugget, jnp.asarray(nd), 0.0)
              for Xc in Xs]
    refs = [pv.block_loglik_parts_t(*b, name=name) for b in blocks]
    one = cv.block_loglik_parts_t(*(_t(a) for a in blocks[0]), name=name)
    _close(one[0], refs[0][0])
    _close(one[1], refs[0][1])
    cand = cv.block_loglik_parts_t(_t(np.stack([np.asarray(b[0]) for b in blocks])),
                                   _t(blocks[0][1]), _t(blocks[0][2]), name=name)
    for c, ref in enumerate(refs):
        _close(cand[0][c], ref[0])
        _close(cand[1][c], ref[1])
    assert cv.launch_counts()["block_loglik_parts_t"]["launches"] == 0


def _edge_blocks(n, m, d, seed, nugget=1e-3):
    """(Xg, yg, diag) from a real NN structure (its first rows have padded,
    sentinel-encoded lanes), built by the JAX package's own gather."""
    X, y, NN = _setup(n=n, d=d, m=m, seed=seed)
    nd = np.random.RandomState(seed).uniform(0.5, 1.0, n)
    out = pv.gather_scale_t(jnp.asarray(X), jnp.asarray(y), jnp.asarray(NN),
                            jnp.asarray(np.linspace(0.4, 0.7, d)), nugget,
                            jnp.asarray(nd), 0.0)
    return tuple(np.asarray(a) for a in out)


# (n, m, d): the edges of the warp kernels' mapping: a full warp (m1 = 32) at
# a ragged n, a two-row block, and five dims
EDGE_SHAPES = dict(argvalues=[(71, 31, 2), (37, 1, 2), (70, 9, 5)],
                   ids=["m32-n71", "m2-n37", "d5"])


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("n,m,d", **EDGE_SHAPES)
def test_cond_weights_plain_matches_pallas(name, n, m, d):
    """K3's plain version against the Pallas kernel on the same blocks."""
    Xg, _, diag = _edge_blocks(n, m, d, seed=12)
    w_t, s_t = cv.cond_weights_t(_t(Xg), _t(diag), name=name)
    w_j, s_j = _jit(pv.cond_weights_t, 'name')(jnp.asarray(Xg), jnp.asarray(diag), name=name)
    assert w_t.shape == (m, n)
    _close(w_t, w_j)
    _close(s_t, s_j)
    assert cv.launch_counts()["cond_weights_t"]["launches"] == 0  # CPU: plain version


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("n,m,d", **EDGE_SHAPES)
def test_block_loglik_parts_plain_matches_pallas_at_edges(name, n, m, d):
    """K4's plain version against the Pallas kernel at the edges, alone and
    with a leading axis of three candidates that each bring their own
    targets and diagonal ((K, m1, n)), one call against three."""
    cands = [_edge_blocks(n, m, d, seed=13 + k, nugget=1e-3 * (1 + k)) for k in range(3)]
    ref = _jit(pv.block_loglik_parts_t, 'name')
    refs = [ref(*(jnp.asarray(a) for a in b), name=name) for b in cands]
    one = cv.block_loglik_parts_t(*(_t(a) for a in cands[0]), name=name)
    _close(one[0], refs[0][0])
    _close(one[1], refs[0][1])
    stacked = [_t(np.stack([b[i] for b in cands])) for i in range(3)]
    out = cv.block_loglik_parts_t(*stacked, name=name)
    assert out[0].shape == (3, n)
    for c, r in enumerate(refs):
        _close(out[0][c], r[0])
        _close(out[1][c], r[1])
    assert cv.launch_counts()["block_loglik_parts_t"]["launches"] == 0  # CPU: plain version


@pytest.mark.parametrize("nugget_est", [True, False])
@pytest.mark.parametrize("rep_prior", [False, True])
def test_vecchia_nllik_fg_matches_autograd(nugget_est, rep_prior):
    """The M-step objective through K1 (plain version on the CPU) against
    torch autograd of the port's reference form `vecchia_nllik`; with
    replicates (W_diag semantics) and a ga prior (tests/test_pallas.py:
    78-105)."""
    X, y, NN = _setup(seed=2)
    n = X.shape[0]
    rs = np.random.RandomState(3)
    if rep_prior:
        nd = 1.0 / rs.randint(1, 4, size=n).astype(np.float64)
        rep = dict(n_orig=float(n) * 1.8, sum_residual=0.37)
        prior = dict(prior_name='ga', prior_coef=[1.2, 0.3])
    else:
        nd = np.ones(n)
        rep = dict(n_orig=float(n), sum_residual=None)
        prior = {}
    params = [0.6, 0.9, 5e-3] if nugget_est else [0.6, 0.9]
    lt = _t(np.log(params))
    kw = dict(name='sexp', scale_est=True, nugget_est=nugget_est, fixed_scale=1.0,
              fixed_nugget=5e-3, **rep)
    args = (_t(X), _t(y), _t(NN), _t(nd))
    nll_k, g_k, scale_k = tcore.vecchia_nllik_fg(lt, *args, n_length=2, **kw, **prior)

    lt_a = lt.clone().requires_grad_(True)
    nll_a, scale_a = tcore.vecchia_nllik(lt_a, *args, **kw)
    if rep_prior:
        lp, _ = tcore.prior_lanes(lt_a, 'ga', 1.2, 0.3)
        nll_a = nll_a - lp.sum()
    nll_a.backward()
    _close(nll_k, nll_a.detach(), rtol=1e-9, atol=0)
    _close(scale_k, scale_a.detach(), rtol=1e-9, atol=0)
    _close(g_k, lt_a.grad, rtol=1e-7, atol=1e-10)
