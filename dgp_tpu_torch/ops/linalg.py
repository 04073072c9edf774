"""Batched linear algebra for small blocks, with a jitter-retry policy;
the counterpart of `dgp_tpu/ops/linalg.py`.

The JAX package unrolls the small-block Cholesky and substitutions over
columns because of how the TPU lowers them; here they are
`torch.linalg.cholesky_ex` and `solve_triangular`.  A block that is not
positive definite factors to NaN (as the unrolled form does through the
square root of a negative pivot) instead of raising, so that callers can
retry only the failed rows.
"""
import torch

from .. import config


def chol_small(A):
    """Lower Cholesky of (..., m, m) blocks; blocks that fail come out NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = info != 0
    if bool(bad.any()):
        L = torch.where(bad[..., None, None], torch.full_like(L, float('nan')), L)
    return L


def safe_cholesky(A):
    """Lower Cholesky with adaptive diagonal jitter: tries
    ``config.CHOLESKY_JITTERS`` (scaled by mean(diag)) until the factor is
    finite.  The escalation is per call, not per batch element."""
    n = A.shape[-1]
    scale = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)[..., None, None]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for jit in config.CHOLESKY_JITTERS:
        L = chol_small(A + jit * scale * eye)
        if bool(torch.isfinite(L).all()):
            return L
    return L


def fwd_solve_small(L, b):
    """Solve L x = b for lower-triangular (..., m, m) L and (..., m) b."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def bwd_solve_small(L, b):
    """Solve L^T x = b for lower-triangular (..., m, m) L and (..., m) b."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), b[..., None],
                                         upper=True)[..., 0]


def cho_solve(L, B):
    """Solve A X = B given the lower Cholesky factor L of A."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def quad_form(A, b):
    """b^T A b for (..., n, n) A and (..., n) b."""
    return torch.einsum("...i,...ij,...j->...", b, A, b)


def sum64(x, dim=None):
    """Sum with float64 accumulation: O(n) log-likelihoods accumulated in
    float32 carry noise comparable to the ESS acceptance margin."""
    x = x.to(torch.float64)
    return x.sum() if dim is None else x.sum(dim=dim)
