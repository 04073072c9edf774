"""Core GP-node math on tensors: the marginal (negative) log-likelihood with
profiled scale, replicate handling and hyper-priors, dense predictions,
linked-GP predictions and the closed-form LOO; the counterpart of
`dgp_tpu/gp_core.py`.

Gradients come from `torch.autograd` where the JAX package takes
`jax.grad`.  Every function takes leading batch axes where the JAX package
would `vmap` it: `log_lik_fixed` over candidate inputs (K, n, d), and
`linkgp_predict` over its M query points at once.
"""
import torch

from .ops import cuda_linked, kernels, linalg


# ----------------------------------------------------------------------
# priors
# ----------------------------------------------------------------------
def log_prior(length, nugget, *, prior_name, prior_coef, nugget_est, cl=None):
    """Log prior on the lengthscales (and the nugget when estimated).

    ``prior_coef`` holds the *adjusted* coefficients the nodes store: for
    'ga' the first entry is shape-1, for 'inv_ga' shape+1 (reference
    kernel_class.py:93-104); for 'ref' (a, b) with b computed at
    initialisation.  For 'ref', ``cl`` may carry leading axes (..., p) and
    the result then has them too."""
    if prior_name is None:
        return 0.0
    if prior_name == "ref":
        return ref_prior_lanes(length, nugget, cl, prior_coef[0], prior_coef[1])[0]
    c0, c1 = prior_coef[0], prior_coef[1]
    if prior_name == "ga":
        lp = torch.sum(c0 * torch.log(length) - c1 * length)
        if nugget_est:
            lp = lp + c0 * torch.log(nugget) - c1 * nugget
    elif prior_name == "inv_ga":
        lp = torch.sum(-c0 * torch.log(length) - c1 / length)
        if nugget_est:
            lp = lp - c0 * torch.log(nugget) - c1 / nugget
    else:
        raise ValueError(f"unknown prior: {prior_name}")
    return lp


def ref_prior_lanes(length, nugget, cl, a, b):
    """The 'ref' log prior a log t - b t, t = sum(cl / length) + nugget, and
    its derivatives with respect to each log-length lane and the
    log-nugget: (lp (...,), dlp_dloglength (..., p), dlp_dlognugget (...,)).
    Lanes broadcast over leading axes."""
    t = torch.sum(cl / length, dim=-1) + nugget
    lp = a * torch.log(t) - b * t
    dlp_dt = a / t - b
    return lp, dlp_dt[..., None] * (-cl / length), dlp_dt * nugget


def compute_cl(X, n_out, n_length, vecch):
    """Characteristic length for the 'ref' prior (kernel_class.py:207-225)
    of (..., n, d) inputs: (..., 1) for an isotropic node, else (..., d)."""
    if n_length == 1:
        if vecch:
            rng = X.amax(dim=-2) - X.amin(dim=-2)
            return (torch.sqrt(torch.sum(rng * rng, dim=-1)) / n_out)[..., None]
        d2 = kernels._sq_dists(X)
        return (torch.sqrt(d2.amax(dim=(-2, -1))) / n_out)[..., None]
    rng = X.amax(dim=-2) - X.amin(dim=-2)
    return rng / n_out ** (1.0 / n_length)


# ----------------------------------------------------------------------
# negative log-likelihood (M-step objective)
# ----------------------------------------------------------------------
def neg_log_lik(log_theta, X, y, *, name, n_length, scale_est, nugget_est,
                fixed_scale, fixed_nugget, prior_name, prior_coef,
                w_diag=None, sum_residual=None, n_orig=None, cl=None):
    """Profiled negative log-likelihood of one GP node.

    Args:
        log_theta: (p [+1],) log lengthscales (+ log nugget if estimated).
        X: (n, d) node input (already concatenated with the global input).
        y: (n,) node output (replicate-collapsed for final-layer nodes).
        w_diag: (n,) replicate weights 1/counts, or None.
        sum_residual: scalar within-replicate residual sum, or None.
        n_orig: original (expanded) data count when replicates exist.
        cl: characteristic lengths for the 'ref' prior.

    Returns:
        (nll, scale): the scalar objective (float64) and the profiled or
        fixed scale.
    """
    if nugget_est:
        length = torch.exp(log_theta[:-1])
        nugget = torch.exp(log_theta[-1])
    else:
        length = torch.exp(log_theta)
        nugget = torch.as_tensor(fixed_nugget, dtype=X.dtype, device=X.device)
    n = y.shape[0]
    K = kernels.k_matrix(X, length, nugget, name, w_diag)
    L = linalg.safe_cholesky(K)
    logdet = linalg.logdet_from_chol(L)
    Kinv_y = linalg.cho_solve(L, y[:, None])[:, 0]
    yKy = linalg.sum64(y * Kinv_y)
    nugget64 = nugget.to(torch.float64)
    has_rep = w_diag is not None
    N = n_orig if has_rep else n

    if scale_est:
        if has_rep:
            scale = (yKy + sum_residual / nugget64) / N
        else:
            scale = yKy / n
        nll = 0.5 * (logdet + N * torch.log(scale))
        if has_rep and nugget_est:
            nll = nll + 0.5 * (N - n) * torch.log(nugget64)
    else:
        scale = torch.as_tensor(fixed_scale, dtype=torch.float64, device=X.device)
        nll = 0.5 * (logdet + yKy / scale)
        if has_rep and nugget_est:
            nll = nll + 0.5 * (sum_residual / (scale * nugget64)
                               + (N - n) * torch.log(nugget64))

    nll = nll - log_prior(length, nugget64, prior_name=prior_name,
                          prior_coef=prior_coef, nugget_est=nugget_est, cl=cl)
    return nll, scale


def neg_log_lik_and_grad(log_theta, X, y, **kw):
    """(nll, grad, scale) of `neg_log_lik`, the gradient by autograd."""
    with torch.enable_grad():
        lt = log_theta.detach().clone().requires_grad_(True)
        nll, scale = neg_log_lik(lt, X, y, **kw)
        g, = torch.autograd.grad(nll, lt)
    return nll.detach(), g, torch.as_tensor(scale).detach()


# ----------------------------------------------------------------------
# marginal log-likelihood (ESS acceptance target)
# ----------------------------------------------------------------------
def log_lik_fixed(X, y, length, scale, nugget, *, name, w_diag=None,
                  ref_prior_coef=None, n_length=None, vecch=False):
    """Gaussian marginal log-likelihood at fixed hyper-parameters
    (kernel_class.log_likelihood_func), with the 'ref' prior term at a
    freshly computed cl (kernel_class.py:489-491).  X may carry leading
    candidate axes (..., n, d); the result then has them too."""
    n = y.shape[-1]
    K = scale * kernels.k_matrix(X, length, nugget, name, w_diag)
    L = linalg.safe_cholesky(K)
    yb = torch.broadcast_to(y, K.shape[:-1])
    quad = linalg.sum64(yb * linalg.cho_solve(L, yb[..., None])[..., 0], dim=-1)
    ll = -0.5 * (linalg.logdet_from_chol(L) + quad)
    if ref_prior_coef is not None:
        cl = compute_cl(X, n, n_length, vecch)
        ll = ll + log_prior(length, nugget, prior_name="ref",
                            prior_coef=ref_prior_coef, nugget_est=False, cl=cl)
    return ll


# ----------------------------------------------------------------------
# predictions
# ----------------------------------------------------------------------
def compute_stats(X, y, length, nugget, *, name, w_diag=None):
    """Rinv and Rinv_y for dense predictions (kernel_class.py:735-751)."""
    K = kernels.k_matrix(X, length, nugget, name, w_diag)
    L = linalg.safe_cholesky(K)
    n = X.shape[-2]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    Rinv = linalg.cho_solve(L, torch.broadcast_to(eye, K.shape))
    Rinv_y = linalg.cho_solve(L, y[..., None])[..., 0]
    return Rinv, Rinv_y


def gp_predict(x, X, Rinv, Rinv_y, scale, length, nugget, *, name):
    """Dense GP prediction at deterministic inputs x (M, d) -> (mean, var)."""
    r = kernels.k_cross(X, x, length, name)      # (n, M)
    mean = r.T @ Rinv_y
    # each query's sum over a contiguous row: its order does not depend on
    # how many queries the call holds (a split into shares)
    rRr = torch.sum((r * (Rinv @ r)).T.contiguous(), dim=1)
    var = torch.abs(scale * (1.0 + nugget - rRr))
    return mean, var


def linkgp_predict(m, v, z, X, Zglobal, Rinv, Rinv_y, scale, length, nugget,
                   *, name):
    """Linked-GP prediction: Gaussian inputs (m, v) (M, Dw), optional
    deterministic global input z (M, Dz).  Returns (mean, var), each (M,).

    The lengthscale vector is broadcast to the full input dimension and
    split between the stochastic (first Dw) and deterministic (last Dz)
    blocks, exactly as functions.link_gp does.  The moments come from K5
    (`cuda_linked.linked_dense_t`): on the card one fused reduction that
    stores no (n, n) moments; on the CPU its plain version."""
    Dw = X.shape[1]
    Dz = 0 if z is None else z.shape[1]
    full_len = torch.broadcast_to(length, (Dw + Dz,))
    length_w, length_z = full_len[:Dw], full_len[Dw:]
    Iz = None if z is None else kernels.k_vec(Zglobal, z, length_z, name)
    mu, tr, quad = cuda_linked.linked_dense_t(X, m, v, Iz, Rinv, Rinv_y, length_w, name=name)
    var = torch.abs(quad - mu**2 + scale * (1.0 + nugget - tr))
    return mu, var


def loo(y, Rinv, Rinv_y, scale):
    """Closed-form leave-one-out mean and variance (gp.py:354-360)."""
    sigma2 = 1.0 / torch.diagonal(Rinv)
    mu = y - Rinv_y * sigma2
    return mu, scale * sigma2
