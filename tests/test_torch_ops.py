"""dgp_tpu_torch.ops against dgp_tpu.ops: kernels, small-block linear
algebra and the linked-GP moments, on the same float64 inputs (made with
numpy), at rtol 1e-9."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgp_tpu.ops import kernels as jk
from dgp_tpu.ops import linalg as jl
from dgp_tpu.ops import moments as jm
from dgp_tpu_torch.ops import kernels as tk
from dgp_tpu_torch.ops import linalg as tl
from dgp_tpu_torch.ops import moments as tm

torch.set_num_threads(1)

RTOL = 1e-9


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("length", [[0.7], [0.4, 1.3]])
def test_kernels_match(name, length):
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (3, 9, 2))
    Z = rs.uniform(-1, 1, (3, 5, 2))
    ln = np.array(length)
    _close(tk.k_cross(_t(X), _t(Z), _t(ln), name),
           jk.k_cross(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(ln), name))
    wd = rs.uniform(0.2, 1.0, 9)
    _close(tk.k_matrix(_t(X), _t(ln), 1e-3, name, _t(wd)),
           jk.k_matrix(jnp.asarray(X), jnp.asarray(ln), 1e-3, name, jnp.asarray(wd)))
    _close(tk.k_vec(_t(X[0]), _t(Z[0, 0]), _t(ln), name),
           jk.k_vec(jnp.asarray(X[0]), jnp.asarray(Z[0, 0]), jnp.asarray(ln), name))
    K = rs.normal(size=(4, 6, 6))
    dg = rs.uniform(size=(4, 6))
    _close(tk.set_diag(_t(K), _t(dg)), jk.set_diag(jnp.asarray(K), jnp.asarray(dg)))


def _spd(rs, b, m):
    G = rs.normal(size=(b, m, m))
    return G @ np.swapaxes(G, -1, -2) + m * np.eye(m)


def test_small_block_linalg_match():
    rs = np.random.RandomState(1)
    A = _spd(rs, 7, 6)
    b = rs.normal(size=(7, 6))
    Lj = jl.chol_small(jnp.asarray(A))
    Lt = tl.chol_small(_t(A))
    _close(Lt, Lj)
    _close(tl.fwd_solve_small(Lt, _t(b)), jl.fwd_solve_small(Lj, jnp.asarray(b)))
    _close(tl.bwd_solve_small(Lt, _t(b)), jl.bwd_solve_small(Lj, jnp.asarray(b)))
    B = rs.normal(size=(7, 6, 3))
    _close(tl.cho_solve(Lt, _t(B)), jl.cho_solve(Lj, jnp.asarray(B)))
    _close(tl.quad_form(_t(A), _t(b)), jl.quad_form(jnp.asarray(A), jnp.asarray(b)))
    x32 = rs.normal(size=(5, 40)).astype(np.float32)
    _close(tl.sum64(_t(x32), dim=1), jl.sum64(jnp.asarray(x32), axis=1))
    assert tl.sum64(_t(x32)).dtype == torch.float64


def test_safe_cholesky_ladder_matches():
    """An indefinite matrix walks the same jitter ladder in both packages;
    a failed factor is NaN (as in the unrolled JAX form), not an error."""
    rs = np.random.RandomState(2)
    G = rs.normal(size=(6, 3))
    A = G @ G.T
    A = A - 1e-7 * np.mean(np.diag(A)) * np.eye(6)
    assert np.isnan(tl.chol_small(_t(A)).numpy()).all()
    _close(tl.safe_cholesky(_t(A)), jl.safe_cholesky(jnp.asarray(A)))
    S = _spd(rs, 1, 5)[0]
    _close(tl.safe_cholesky(_t(S)), jl.safe_cholesky(jnp.asarray(S)))


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_linked_moments_match(name):
    """IJ over a batch of Gaussian test inputs (one dim deterministic:
    z_v == 0 falls back to plain kernel evaluations)."""
    rs = np.random.RandomState(3)
    M, n, d = 4, 7, 2
    X = rs.uniform(-1, 1, (M, n, d))
    zm = rs.uniform(-1, 1, (M, d))
    zv = rs.uniform(0.01, 0.2, (M, d))
    zv[1, 0] = 0.0
    length = np.array([0.6, 0.9])
    I_t, J_t = tm.IJ(_t(X), _t(zm), _t(zv), _t(length), name)
    I_j, J_j = jax.vmap(lambda x, a, b: jm.IJ(x, a, b, jnp.asarray(length), name))(
        jnp.asarray(X), jnp.asarray(zm), jnp.asarray(zv))
    _close(I_t, I_j)
    _close(J_t, J_j)
