"""K1, the Vecchia gradient kernel, with more length lanes than one pass of
its gradient stage accumulates (8) and at the blocks it takes with two
rows per lane (33 <= m1 <= 64): its plain version, which the kernel is
held to on the card, against dgp_tpu on the same float64 inputs.

At n_length = 9, 12, 16 and 17 (d = n_length; 16 leaves the nugget lane
alone in the last pass, 17 a length lane with it), with and without the
nugget lane, at m1 = 10, against the Pallas gradient kernel in interpret
mode.  At m1 = 33, 41 and 64 the interpret mode takes more than ten
minutes per case on the CPU (its trace grows with m1), so there the M-step
objective and gradient through the plain version are held to
jax.value_and_grad of the JAX package's XLA form
(`vecchia.core.vecchia_nllik`, the path dgp_tpu itself runs off the TPU and
above m1 = 64).  Tolerances as in tests/test_torch_vecchia.py: rtol 1e-9
for values, rtol 1e-7, atol 1e-10 for gradients.  Last, the gate admits
K1 at no fewer dims than before the gradient stage was redesigned."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgp_tpu.ops import pallas_vecchia as pv
from dgp_tpu.vecchia import core as jcore
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.vecchia import core as tcore
from test_torch_vecchia import _close, _grad_blocks, _jit, _setup, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("name,nugget_est,n_length", [
    ("sexp", True, 9), ("matern2.5", False, 9), ("matern2.5", True, 12), ("sexp", False, 12),
    ("sexp", True, 16), ("matern2.5", False, 16), ("matern2.5", True, 17),
    ("sexp", False, 17)])
def test_block_nllik_grad_lanes_match_pallas(name, nugget_est, n_length):
    """K1's plain version against the Pallas gradient kernel with 9, 12, 16
    and 17 length lanes (d = n_length), with and without the nugget lane, and a
    leading node axis of two parameter settings."""
    groups = [_grad_blocks(n_length, seed, 50, 9, n_length) for seed in (0, 1)]
    kw = dict(name=name, n_length=n_length, nugget_est=nugget_est)
    out_t = cv.block_nllik_grad_parts_t(*[_t(np.stack([g[i] for g in groups]))
                                          for i in range(4)], **kw)
    assert out_t[2].shape == (2, n_length + int(nugget_est), 50)
    ref = _jit(pv.block_nllik_grad_parts_t, 'name', 'n_length', 'nugget_est')
    for gi, g in enumerate(groups):
        out_j = ref(*(jnp.asarray(a) for a in g), **kw)
        _close(out_t[0][gi], out_j[0])
        _close(out_t[1][gi], out_j[1])
        for a, b in zip(out_t[2:], out_j[2:]):
            _close(a[gi], b, rtol=1e-7, atol=1e-10)
    assert cv.launch_counts()["block_nllik_grad_parts_t"]["launches"] == 0


@pytest.mark.parametrize("m1,d,n_length,nugget_est,name", [
    (33, 2, 2, True, "sexp"), (41, 2, 1, True, "matern2.5"), (64, 2, 2, False, "matern2.5"),
    (64, 9, 9, True, "sexp"), (26, 12, 12, True, "matern2.5"), (41, 12, 1, False, "sexp"),
    (64, 12, 12, True, "matern2.5"), (33, 17, 17, False, "sexp")],
    ids=["m33", "m41-iso", "m64", "m64-lanes9", "lanes12", "m41-d12-iso", "m64-lanes12",
         "m33-lanes17"])
def test_vecchia_nllik_fg_two_rows_matches_jax_autodiff(m1, d, n_length, nugget_est, name):
    """The M-step objective and its gradient through K1's plain version
    against jax.value_and_grad of dgp_tpu's XLA objective on the same
    ordered data and neighbours."""
    X, y, NN = _setup(n=m1 + 60, d=d, m=m1 - 1, seed=4)
    n = X.shape[0]
    nd = np.ones(n)
    length = np.linspace(0.5, 0.9, n_length) * (1.0 if d <= 2 else np.sqrt(d))
    lt = np.log(np.concatenate([length, [5e-3]]) if nugget_est else length)
    kw = dict(name=name, scale_est=True, nugget_est=nugget_est, fixed_scale=1.0,
              fixed_nugget=5e-3, n_orig=float(n), sum_residual=None)
    nll_t, g_t, scale_t = tcore.vecchia_nllik_fg(_t(lt), _t(X), _t(y), _t(NN), _t(nd),
                                                 n_length=n_length, **kw)

    def f(lt_):
        nll, scale = jcore.vecchia_nllik(lt_, jnp.asarray(X), jnp.asarray(y),
                                         jnp.asarray(NN), jnp.asarray(nd), **kw)
        return nll, scale

    (nll_j, scale_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(lt))
    _close(nll_t, nll_j, rtol=1e-9, atol=0)
    _close(scale_t, scale_j, rtol=1e-9, atol=0)
    _close(g_t, g_j, rtol=1e-7, atol=1e-10)
    assert g_t.shape == (n_length + int(nugget_est),)
    assert cv.launch_counts()["block_nllik_grad_parts_t"]["launches"] == 0


@pytest.mark.parametrize("m1,dtype,d_last", [
    (26, torch.float64, 1076), (33, torch.float64, 840), (48, torch.float64, 546),
    (64, torch.float64, 384), (26, torch.float32, 2194), (33, torch.float32, 1721),
    (48, torch.float32, 1151), (64, torch.float32, 838)])
def test_gate_admits_k1_at_no_fewer_dims(m1, dtype, d_last):
    """`use_kernel("K1", ...)` takes every d up to the last one the formula
    took before the gradient stage was redesigned (hard-coded), and
    `shared_bytes` stays within one SM's 227 KB there."""
    assert cv.use_kernel("K1", m1, d_last, dtype)
    assert cv.shared_bytes("K1", m1, d_last, dtype) <= cv.SMEM_MAX
    assert all(cv.use_kernel("K1", m1, d, dtype) for d in range(1, d_last + 1))
