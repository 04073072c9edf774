"""Stationary correlation kernels (squared-exponential and separable
Matern-2.5) as batched torch ops; the counterpart of `dgp_tpu/ops/kernels.py`.

Conventions (identical to the JAX package and its reference):
  - `sexp`:      k(x, y) = exp(-sum_d ((x_d - y_d) / l_d)^2)        (no 1/2!)
  - `matern2.5`: k(x, y) = prod_d (1 + sqrt5 a_d + (5/3) a_d^2) * exp(-sqrt5 * sum_d a_d)
                 with a_d = |x_d - y_d| / l_d
  - the diagonal of a training matrix is 1 + nugget (optionally scaled by
    per-point replicate weights ``w_diag``).
"""
import torch

SQRT5 = 2.23606797749978969


def _sq_dists(X, Z=None):
    """Pairwise squared euclidean distances, (..., n, m), from explicit
    differences: the Gram-matrix identity loses the small distances between
    near-coincident points to cancellation."""
    if Z is None:
        Z = X
    diff = X[..., :, None, :] - Z[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def k_cross(X, Z, length, name):
    """Cross-correlation matrix between (..., n, d) X and (..., m, d) Z with
    (p,) lengthscales, p == 1 or p == d.  Returns (..., n, m)."""
    Xl, Zl = X / length, Z / length
    if name == "sexp":
        return torch.exp(-_sq_dists(Xl, Zl))
    if name == "matern2.5":
        a = torch.abs(Xl[..., :, None, :] - Zl[..., None, :, :])
        coef = torch.prod(1.0 + SQRT5 * a + (5.0 / 3.0) * a * a, dim=-1)
        return coef * torch.exp(-SQRT5 * torch.sum(a, dim=-1))
    raise ValueError(f"unknown kernel name: {name}")


def set_diag(K, diag):
    """Replace the diagonal of (..., n, n) K with ``diag`` (scalar or (..., n))."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    diag = torch.as_tensor(diag, dtype=K.dtype, device=K.device)
    diag = torch.broadcast_to(diag, K.shape[:-1])
    return K * (1.0 - eye) + diag[..., None] * eye


def k_matrix(X, length, nugget, name, w_diag=None):
    """Training correlation matrix (..., n, n) with diag = 1 + nugget * w_diag."""
    K = k_cross(X, X, length, name)
    diag = 1.0 + nugget * (w_diag if w_diag is not None else 1.0)
    return set_diag(K, diag)


def k_vec(X, z, length, name):
    """Correlation vector between training points (..., n, d) X and one point
    (..., d) z."""
    return k_cross(X, z[..., None, :], length, name)[..., 0]
