"""Batched linear algebra for small blocks and dense GP matrices, with a
jitter-retry policy; the counterpart of `dgp_tpu/ops/linalg.py`.

The JAX package unrolls the small-block Cholesky and substitutions over
columns because of how the TPU lowers them; here they are
`torch.linalg.cholesky_ex` and `solve_triangular`.  A block that is not
positive definite factors to NaN (as the unrolled form does through the
square root of a negative pivot) instead of raising, so that callers can
retry only the failed rows.
"""
import torch

from .. import config, tracing


def chol_small(A):
    """Lower Cholesky of (..., m, m) blocks; blocks that fail come out NaN.
    No value is read back to the host."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float('nan'), L)


def cholesky(A):
    """Plain lower Cholesky (batched, no jitter retry); a matrix that is not
    positive definite factors to NaN, as `jnp.linalg.cholesky` does."""
    return chol_small(A)


def safe_cholesky(A):
    """Lower Cholesky with adaptive diagonal jitter: the first of
    ``config.CHOLESKY_JITTERS`` (scaled by mean(diag)) whose factor is
    finite, or the last.  Each matrix of a batch settles on its own level,
    as the JAX package's retry loop does under `vmap`; differentiable
    through the factor at that level.  One host read per level tried."""
    def attempt(jit):
        if not jit:
            return chol_small(A)
        scale = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)[..., None, None]
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return chol_small(A + jit * scale * eye)

    jitters = config.CHOLESKY_JITTERS
    L = attempt(jitters[0])
    for jit in jitters[1:]:
        bad = ~torch.isfinite(L).all(-1).all(-1)
        if not bool(tracing.to_host(bad.any(), 'jitter_check')):
            break
        L = torch.where(bad[..., None, None], attempt(jit), L)
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


def logdet_from_chol(L):
    """log|A| from its lower Cholesky factor (batched -> (...,)), accumulated
    in float64 (see `sum64`)."""
    return 2.0 * sum64(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))), dim=-1)


def quad_form(A, b):
    """b^T A b for (..., n, n) A and (..., n) b."""
    return torch.einsum("...i,...ij,...j->...", b, A, b)


def trace_prod(A, B):
    """tr(A @ B) without forming the product."""
    return torch.sum(A * B.transpose(-1, -2), dim=(-2, -1))


def sum64(x, dim=None):
    """Sum with float64 accumulation: O(n) log-likelihoods accumulated in
    float32 carry noise comparable to the ESS acceptance margin."""
    x = x.to(torch.float64)
    return x.sum() if dim is None else x.sum(dim=dim)


def mvn_sample(gen, L, mean=None):
    """Sample from N(mean, L L^T) given a lower Cholesky factor (batched);
    ``gen`` is a torch.Generator on L's device."""
    sn = torch.randn(L.shape[:-1], generator=gen, dtype=L.dtype, device=L.device)
    samp = torch.einsum("...ij,...j->...i", L, sn)
    return samp if mean is None else samp + mean
