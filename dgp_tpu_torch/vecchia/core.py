"""Vecchia-approximation compute as batched torch ops; the counterpart of
`dgp_tpu/vecchia/core.py`.

Every per-point (m+1)-block is gathered into one (n, m+1, m+1) tensor and
factorised in one batched call.  Padded lanes (points with fewer than m
predecessors, marked -1 in NNarray) are decoupled by masking their rows and
columns to the identity, which leaves the final-element conditionals equal
to the unpadded computation.

The kernels' wrappers (`ops.cuda_vecchia`) carry the hot paths: the
log-likelihood at fixed parameters (`vecchia_llik`, K4), the M-step
objective with its analytic gradient (`vecchia_nllik_fg`, K1) and the
conditional weights of ancestral sampling (`cond_weights`, K3).
`vecchia_nllik` keeps the masked-block form with an autograd gradient as
the reference for K1.

Blocks the kernels do not take (`cv.use_kernel`: more than 64 rows, or
staged tiles beyond one SM's shared memory) go the large-block route, the
counterpart of the JAX package's XLA branch (`dgp_tpu/vecchia/core.py:
56-88, 216`; `models/mstep.py:165-174`): the same masked blocks as
`vecchia_nllik`, factored by `linalg.chol_small` in chunks of points that
keep their temporaries within `ROUTE_BUDGET` bytes, with K1's gradients
from autograd.  Each caller decides from the shapes alone, the same on
every device, before anything runs; the route returns the per-point
arrays the kernel would, so no result depends on the chunk, and
`route_counts` counts its calls per kernel id.

`llik_parts` and `cond_parts` give K4's and K3's per-point outputs (or
the route's) for a range of the points, so that a split over several
devices (`models/compiled.py`) can compute each share on its own device;
`llik_total` and `join_weights` reduce and join them as one call would.

Prediction (`gp_vecch`, `link_gp_vecch`) is one K6 launch a call on the
card (`ops.cuda_pred`), by the same gate: the plain versions
(`gp_vecch_plain`, `link_gp_vecch_plain`, batched torch.linalg) run on the
CPU and, for blocks above K6's bound, on the card.  The closed-form LOO
(`loo_gp_vecch`) and the exact draw of the Hetero mean (`post_het_vecch`)
are batched torch.linalg.
"""
import numpy as np
import torch

from .. import gp_core
from ..ops import cuda_pred as cpred
from ..ops import cuda_vecchia as cv
from ..ops import kernels as kops
from ..ops import linalg


def _f32_jitter(dtype):
    """Fixed diagonal jitter for float32 Vecchia blocks: near-ones
    correlation blocks lose positive definiteness under float32 Cholesky; a
    3e-5 floor (small against the usual 1e-4..1e-2 estimated nuggets,
    invisible in float64) keeps the factorisations finite."""
    return 3e-5 if dtype == torch.float32 else 0.0


#: extra block diagonals that callers of the predictions (`gp_vecch`,
#: `link_gp_vecch`, `loo_gp_vecch`) try, in order, for rows whose
#: factorisation comes out non-finite (prediction blocks can be larger than
#: the training m); the healthy rows are kept
PRED_JITTER_RUNGS = (3e-4, 3e-3)


def _eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def _masked_blocks(Xi, yi, nd_i, valid, length, nugget, name):
    """(..., m+1, m+1) kernel blocks of gathered neighbour sets Xi (...,
    m+1, d) with invalid lanes decoupled to the identity, and the masked
    targets; ``length`` and ``nugget`` broadcast against Xi's and nd_i's
    leading axes."""
    K = kops.k_cross(Xi, Xi, length, name)
    both = valid[..., :, None] & valid[..., None, :]
    K = torch.where(both, K, _eye_like(K))
    diag = torch.where(valid, 1.0 + nugget * nd_i + _f32_jitter(K.dtype), 1.0)
    return kops.set_diag(K, diag), torch.where(valid, yi, 0.0)


def _blocks(X, y, NNarray, length, nugget, name, nugget_diag):
    """Masked (n, m+1, m+1) kernel blocks in ascending order (self last)
    plus masked targets.  Returns (K, y_blk, valid)."""
    rev = torch.flip(NNarray, dims=(1,))
    valid = rev >= 0
    safe = torch.where(valid, rev, 0)
    K, yi = _masked_blocks(X[safe], y[safe], nugget_diag[safe], valid, length, nugget,
                           name)
    return K, yi, valid


# ----------------------------------------------------------------------
# the large-block route: blocks outside the kernels' bound
# ----------------------------------------------------------------------
#: bytes of block temporaries one chunk of the large-block route may hold
#: (the ensemble's query budget): m = 200 at n = 1e5 has 32 GB of float64
#: blocks
ROUTE_BUDGET = 1 << 30

_ROUTE_COUNTS = {"K1": 0, "K3": 0, "K4": 0}


def route_counts():
    """Calls of the large-block route since the last reset, by the id of
    the kernel whose bound sent them there."""
    return dict(_ROUTE_COUNTS)


def reset_route_counts():
    for kid in _ROUTE_COUNTS:
        _ROUTE_COUNTS[kid] = 0


def _route_step(lead, m1, d, dtype):
    """Points per chunk: as many as keep ``lead`` (the product of the
    leading candidate or node axes) blocks of m1 rows each, and their
    temporaries (the kernel's (m1, m1, d) differences among them), within
    `ROUTE_BUDGET`; at least one."""
    item = torch.finfo(dtype).bits // 8
    per_point = max(1, lead) * (8 + 4 * d) * m1 * m1 * item
    return max(1, ROUTE_BUDGET // per_point)


def _chunks(n, step):
    return [slice(s, min(s + step, n)) for s in range(0, n, step)]


def _llik_route(X, y, NNarray, length, nugget, nugget_diag, name):
    """K4's per-point (logdet (..., n), quad (..., n)) on masked blocks,
    chunk by chunk; X may carry leading candidate axes (..., n, d)."""
    _ROUTE_COUNTS["K4"] += 1
    rev = torch.flip(NNarray, dims=(1,))
    valid = rev >= 0
    safe = torch.where(valid, rev, 0)
    n, m1 = NNarray.shape
    step = _route_step(int(np.prod(X.shape[:-2])), m1, X.shape[-1], X.dtype)
    parts = []
    for sl in _chunks(n, step):
        idx = safe[sl]
        K, yi = _masked_blocks(X[..., idx, :], y[idx], nugget_diag[idx], valid[sl],
                               length, nugget, name)
        L = linalg.chol_small(K)
        Ly = linalg.fwd_solve_small(L, torch.broadcast_to(yi, K.shape[:-1]))
        parts.append((2.0 * torch.log(torch.abs(L[..., -1, -1])), Ly[..., -1] ** 2))
    return tuple(torch.cat(p, dim=-1) for p in zip(*parts))


def _cond_weights_route(X, NNarray, length, nugget, name, nugget_diag):
    """K3's (w (n, m), sigma (n,)) on masked blocks, chunk by chunk."""
    _ROUTE_COUNTS["K3"] += 1
    rev = torch.flip(NNarray, dims=(1,))
    valid = rev >= 0
    safe = torch.where(valid, rev, 0)
    n, m1 = NNarray.shape
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    parts = []
    for sl in _chunks(n, _route_step(1, m1, X.shape[-1], X.dtype)):
        idx = safe[sl]
        K, _ = _masked_blocks(X[idx], zero, nugget_diag[idx], valid[sl], length, nugget,
                              name)
        L = linalg.chol_small(K)
        # w^T = L[-1, :-1] inv(L[:-1, :-1]): w = solve(L[:-1, :-1]^T, L[-1, :-1])
        parts.append((linalg.bwd_solve_small(L[:, :-1, :-1], L[:, -1, :-1]),
                      L[:, -1, -1]))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def nllik_grad_route(Xg_raw, yg, nug_g, valid, lanes, params, name):
    """K1's per-point outputs by autograd on masked blocks, chunk by
    chunk: (logdet (..., n), quad (..., n), dlogdet (..., p, n), dquad
    (..., p, n)), the gradients in the log-parameters ``lanes`` (..., p);
    dquad is, as K1's, the gradient of -quad.
    The operands are K1's raw gathers in the transposed layout
    (`cv.gather_raw_t`; a leading node axis allowed): Xg_raw (..., m1, d,
    n), yg, nug_g and valid (..., m1, n).  ``params(lanes)`` gives (length
    (..., n_length), nugget (...)); each point differentiates its own copy
    of the lanes, so its gradient does not depend on the chunk."""
    _ROUTE_COUNTS["K1"] += 1
    m1, d, n = Xg_raw.shape[-3:]
    lead = lanes.shape[:-1]
    p = lanes.shape[-1]
    parts = []
    for sl in _chunks(n, _route_step(int(np.prod(lead)), m1, d, Xg_raw.dtype)):
        # contiguous, so that the backward pass reduces in the same order
        # whatever the chunk and the share around it
        Xi = Xg_raw[..., sl].movedim(-1, -3).contiguous()     # (..., c, m1, d)
        vi, yi, ni = (t[..., sl].transpose(-1, -2).contiguous()
                      for t in (valid, yg, nug_g))
        with torch.enable_grad():
            lp = (lanes.detach()[..., None, :].expand(*lead, Xi.shape[-3], p)
                  .clone().requires_grad_(True))              # (..., c, p)
            length, nugget = params(lp)
            K, yb = _masked_blocks(Xi, yi, ni, vi, length[..., None, :],
                                   nugget[..., None], name)
            L = linalg.chol_small(K)
            Ly = linalg.fwd_solve_small(L, yb)
            logdet = 2.0 * torch.log(torch.abs(L[..., -1, -1]))
            quad = Ly[..., -1] ** 2
            dlogdet, = torch.autograd.grad(logdet.sum(), lp, retain_graph=True)
            dquad, = torch.autograd.grad(-quad.sum(), lp)
        parts.append((logdet.detach(), quad.detach(), dlogdet.transpose(-1, -2),
                      dquad.transpose(-1, -2)))
    return tuple(torch.cat(t, dim=-1) for t in zip(*parts))


def llik_parts(X, y, NNarray, length, nugget, nugget_diag, name, start=0):
    """Per-point (logdet (..., n), quad (..., n)) of `vecchia_llik` for the
    points whose neighbour rows NNarray holds (start.., all of X's by
    default): one K4 launch, or the large-block route outside K4's bound."""
    if cv.use_kernel("K4", NNarray.shape[1], X.shape[-1], X.dtype):
        Xg, yg, diag = cv.gather_scale_t(X, y, NNarray, length, nugget, nugget_diag,
                                         _f32_jitter(X.dtype), start)
        return cv.block_loglik_parts_t(Xg, yg, diag, name=name)
    return _llik_route(X, y, NNarray, length, nugget, nugget_diag, name)


def vecchia_llik(X, y, NNarray, scale, length, nugget, nugget_diag, name):
    """Vecchia log-likelihood at fixed parameters (reference vecchia_llik):
    the scale enters only through quad/scale; the parameter-constant
    normalisation is dropped.  Accumulated in float64.

    X may carry a leading candidate axis, (K, n, d), for K inputs that
    share y, the NN structure and the parameters (the candidates of one
    node-wise ESS round); the result is then (K,).  One K4 launch either
    way, or the large-block route outside K4's bound."""
    return llik_total(*llik_parts(X, y, NNarray, length, nugget, nugget_diag, name),
                      scale)


def llik_total(logdet_i, quad_i, scale):
    """`vecchia_llik` from its per-point parts."""
    quad = linalg.sum64(quad_i, dim=-1)
    logdet = linalg.sum64(logdet_i, dim=-1)
    scale64 = torch.as_tensor(scale, dtype=torch.float64, device=quad.device)
    return -0.5 * (logdet + quad / scale64)


def _profiled(logdet, quad, nugget, *, n, scale_est, nugget_est, fixed_scale,
              n_orig, sum_residual):
    """(nll, scale) from the float64 block sums (reference vecchia_nllik's
    profiling and replicate terms)."""
    nugget = torch.as_tensor(nugget, dtype=torch.float64, device=quad.device)
    has_rep = sum_residual is not None
    N = n_orig if has_rep else n
    if scale_est:
        scale = (quad + sum_residual / nugget) / N if has_rep else quad / n
        nll = 0.5 * (logdet + N * torch.log(scale))
        if has_rep and nugget_est:
            nll = nll + 0.5 * (N - n) * torch.log(nugget)
    else:
        scale = torch.as_tensor(fixed_scale, dtype=torch.float64, device=quad.device)
        nll = 0.5 * (logdet + quad / scale)
        if has_rep and nugget_est:
            nll = nll + 0.5 * (sum_residual / (scale * nugget) + (N - n) * torch.log(nugget))
    return nll, scale


def _params(log_theta, nugget_est, fixed_nugget):
    """(length, nugget) of log-parameters (..., p)."""
    if nugget_est:
        return torch.exp(log_theta[..., :-1]), torch.exp(log_theta[..., -1])
    return torch.exp(log_theta), fixed_nugget


def vecchia_nllik(log_theta, X, y, NNarray, nugget_diag, *, name, scale_est,
                  nugget_est, fixed_scale, fixed_nugget, n_orig, sum_residual):
    """Profiled Vecchia negative log-likelihood (reference vecchia_nllik
    semantics) on masked blocks and a library Cholesky, differentiable by
    autograd: the reference form K1's analytic gradient is held against.
    Returns (nllik, scale)."""
    length, nugget = _params(log_theta, nugget_est, fixed_nugget)
    K, yi, _ = _blocks(X, y, NNarray, length, nugget, name, nugget_diag)
    L = linalg.chol_small(K)
    Ly = linalg.fwd_solve_small(L, yi)
    quad = linalg.sum64(Ly[:, -1] ** 2)
    logdet = linalg.sum64(2.0 * torch.log(torch.abs(L[:, -1, -1])))
    return _profiled(logdet, quad, nugget, n=X.shape[0], scale_est=scale_est,
                     nugget_est=nugget_est, fixed_scale=fixed_scale,
                     n_orig=n_orig, sum_residual=sum_residual)


def prior_lanes(lt, prior_name, c0, c1):
    """Per-lane log-prior of log-parameters lt and its derivative, for the
    gamma ('ga') and inverse-gamma ('inv_ga') priors with the adjusted
    coefficients (c0, c1) the nodes store (reference kernel_class.py:
    367-401).  The 'ref' prior couples the lanes through the inputs'
    characteristic length: `gp_core.ref_prior_lanes`."""
    if prior_name == 'ga':
        e = torch.exp(lt)
        return c0 * lt - c1 * e, c0 - c1 * e
    if prior_name == 'inv_ga':
        e = torch.exp(-lt)
        return -c0 * lt - c1 * e, -c0 + c1 * e
    raise ValueError(f"no per-lane form for the prior: {prior_name}")


def vecchia_nllik_fg(log_theta, X, y, NNarray, nugget_diag, *, name, n_length,
                     scale_est, nugget_est, fixed_scale, fixed_nugget, n_orig,
                     sum_residual, prior_name=None, prior_coef=None, raw=None):
    """Profiled Vecchia negative log-likelihood AND its gradient with
    respect to the log-parameters, through the K1 kernel's analytic
    gradient (dgpsi/vecchia.py:182-242).  Returns (nll, grad, scale).

    ``raw`` optionally carries the parameter-independent block gathers of
    `cv.gather_raw_t`, so that the evaluations of one optimisation gather
    once.  The 'ref' prior's characteristic length comes from X as the
    Vecchia node computes it (`gp_core.compute_cl` with vecch=True).
    Outside K1's bound the parts come from the large-block route."""
    length, nugget = _params(log_theta, nugget_est, fixed_nugget)
    if raw is None:
        raw = cv.gather_raw_t(X, y, NNarray, nugget_diag)
    Xg_raw, yg, nug_g, valid = raw
    if cv.use_kernel("K1", NNarray.shape[1], X.shape[1], X.dtype):
        Xg, diag, dnug = cv.scale_blocks_t(Xg_raw, nug_g, valid, length, nugget,
                                           _f32_jitter(X.dtype))
        logdet_i, quad_i, dlogdet_i, dquad_i = cv.block_nllik_grad_parts_t(
            Xg, yg, diag, dnug, name=name, n_length=n_length, nugget_est=nugget_est)
    else:
        def params(lt):
            ln, nug = _params(lt, nugget_est, fixed_nugget)
            return ln, torch.as_tensor(nug, dtype=lt.dtype,
                                       device=lt.device).expand(lt.shape[:-1])
        logdet_i, quad_i, dlogdet_i, dquad_i = nllik_grad_route(
            Xg_raw, yg, nug_g, valid, log_theta, params, name)
    quad, logdet = linalg.sum64(quad_i), linalg.sum64(logdet_i)
    dquad, dlogdet = linalg.sum64(dquad_i, dim=1), linalg.sum64(dlogdet_i, dim=1)
    n = X.shape[0]
    nll, scale = _profiled(logdet, quad, nugget, n=n, scale_est=scale_est,
                           nugget_est=nugget_est, fixed_scale=fixed_scale,
                           n_orig=n_orig, sum_residual=sum_residual)
    g = 0.5 * (dlogdet - dquad / scale)
    if sum_residual is not None and nugget_est:
        nug64 = torch.as_tensor(nugget, dtype=torch.float64, device=g.device)
        g[-1] = g[-1] + 0.5 * (-sum_residual / (scale * nug64) + (n_orig - n))
    if prior_name is not None:
        c = torch.as_tensor(prior_coef, dtype=log_theta.dtype, device=log_theta.device)
        if prior_name == 'ref':
            cl = gp_core.compute_cl(X, n, n_length, True)
            nug = torch.as_tensor(nugget, dtype=log_theta.dtype, device=log_theta.device)
            lp, dlen, dnug_lp = gp_core.ref_prior_lanes(length, nug, cl, c[0], c[1])
            dlp = torch.cat([dlen, dnug_lp[None]]) if nugget_est else dlen
        else:
            lp, dlp = prior_lanes(log_theta, prior_name, c[0], c[1])
            lp = lp.sum()
        nll = nll - lp
        g = g - dlp
    return nll, g.to(log_theta.dtype), scale


def cond_parts(X, NNarray, length, nugget, name, nugget_diag=None, pre=None, start=0):
    """The per-point (w (n, m), sigma (n,)) of `cond_weights`, unmasked,
    for the points whose neighbour rows NNarray holds (start.., all of X's
    by default): one K3 launch, whose w is the transpose of its (m, n)
    output, or the large-block route outside K3's bound, which gathers its
    own blocks.  ``pre`` carries the gathered blocks of those points
    (`cond_weights`)."""
    nd = (torch.ones(X.shape[0], dtype=X.dtype, device=X.device) if nugget_diag is None
          else nugget_diag)
    if not cv.use_kernel("K3", NNarray.shape[1], X.shape[1], X.dtype):
        return _cond_weights_route(X, NNarray, length, nugget, name, nd)
    jit = _f32_jitter(X.dtype)
    if pre is not None:
        Xg_raw, nug_g, validT = pre
        Xg, diag, _ = cv.scale_blocks_t(Xg_raw, nug_g, validT, length, nugget, jit, start)
    else:
        Xg, _, diag = cv.gather_scale_t(X, torch.zeros_like(X[:, 0]), NNarray,
                                        length, nugget, nd, jit, start)
    w_t, sigma = cv.cond_weights_t(Xg, diag, name=name)
    return w_t.T, sigma


def join_weights(gather, parts, NNarray, X):
    """The shares' `cond_parts` joined by ``gather`` (list, dim) -> tensor
    in the layout of one call over all points: K3's w as the transpose of
    its joined (m, n) outputs, the route's joined by rows."""
    ws, sigmas = zip(*parts)
    if cv.use_kernel("K3", NNarray.shape[1], X.shape[1], X.dtype):
        w = gather([w.T for w in ws], -1).T
    else:
        w = gather(list(ws), 0)
    return w, gather(list(sigmas), 0)


def cond_weights(X, NNarray, length, nugget, name, nugget_diag=None, pre=None,
                 parts=None):
    """Per-point conditional weights for ancestral Vecchia sampling.

    For each ordered point i with ascending neighbour set N(i):
        x_i | x_N(i) ~ N(w_i . x_N(i), scale * sigma_i^2)
    Returns (w (n, m), sigma (n,), idx_asc (n, m), valid (n, m+1)).

    ``pre`` optionally carries the parameter-independent gathered blocks
    (Xg_raw (m1, d, n), nug_g (m1, n), validT (m1, n)) from
    `CompiledDGP._chunk_static`; the large-block route, outside K3's bound,
    gathers its own.  ``parts`` brings (w, sigma) of `cond_parts`, computed
    elsewhere (a split over several devices)."""
    rev = torch.flip(NNarray, dims=(1,))
    valid = rev >= 0
    w, sigma = parts if parts is not None else cond_parts(
        X, NNarray, length, nugget, name, nugget_diag, pre)
    w = torch.where(valid[:, :-1], w, 0.0)
    idx_asc = torch.where(valid, rev, 0)[:, :-1]
    return w, sigma, idx_asc, valid


def _unitri_inverse(W):
    """(..., B, B) inverse of (I - W) for strictly-lower-triangular W by
    Neumann doubling: (I-W)^{-1} = prod_k (I + W^{2^k}), exact after
    ceil(log2 B) steps since W^B = 0."""
    B = W.shape[-1]
    M = _eye_like(W) + W
    A = W
    steps = max(1, int(np.ceil(np.log2(max(B, 2)))))
    for _ in range(steps - 1):
        A = A @ A
        M = M + M @ A
    return M


def ancestral_sample(eps, w, idx_asc, block=512):
    """Vecchia ancestral pass x_i = w_i . x_{N(i)} + eps_i in O(n/block)
    sequential steps: the ordering is cut into blocks; cross-block terms are
    gathers from finished entries, and within-block coupling is solved by a
    precomputed dense per-block inverse (batched over blocks).

    Args:
        eps: (S, n) independent noise, already scaled by the conditional sd.
        w: (n, m) conditional weights (0 on padded lanes).
        idx_asc: (n, m) ascending neighbour indices (0 on padded lanes).
    Returns:
        (S, n) samples.
    """
    S, n = eps.shape
    m = w.shape[1]
    if n > 32768:
        block = min(block, 256)
    elif block == 512:
        block = 128
    B = min(block, max(64, 1 << int(np.ceil(np.log2(max(n, 2))))))
    n_pad = ((n + B - 1) // B) * B
    nb = n_pad // B
    if n_pad != n:
        eps = torch.nn.functional.pad(eps, (0, n_pad - n))
        w = torch.nn.functional.pad(w, (0, 0, 0, n_pad - n))
        idx_asc = torch.nn.functional.pad(idx_asc, (0, 0, 0, n_pad - n))

    base = (torch.arange(n_pad, dtype=idx_asc.dtype, device=idx_asc.device)
            // B) * B
    rel = idx_asc - base[:, None]                        # (n_pad, m)
    in_blk = (rel >= 0) & (w != 0)
    # each row's in-block weights at their columns (a row's neighbours are
    # distinct); the other lanes park in column B, dropped.  A scatter: an
    # (n, m, B) one-hot would take 51 GB at n = 1e6
    rel_safe = torch.where(in_blk, rel, B)
    w_in = torch.where(in_blk, w, 0.0)
    Wflat = torch.zeros((n_pad, B + 1), dtype=w.dtype, device=w.device).scatter_add_(
        1, rel_safe.long(), w_in)[:, :B]
    M = _unitri_inverse(Wflat.reshape(nb, B, B))          # (nb, B, B)

    w_cross = torch.where(in_blk, 0.0, w).reshape(nb, B, m)
    idx_b = idx_asc.reshape(nb, B, m)
    eps_b = eps.reshape(S, nb, B)
    x = torch.zeros((S, n_pad), dtype=eps.dtype, device=eps.device)
    for b in range(nb):
        gathered = x[:, idx_b[b]]                         # (S, B, m)
        c = eps_b[:, b] + torch.einsum('sbm,bm->sb', gathered, w_cross[b])
        x[:, b * B:(b + 1) * B] = torch.einsum('ij,sj->si', M[b], c)
    return x[:, :n]


def fmvn_sp(gen, X, NNarray, scale, length, nugget, name, S=None, parts=None):
    """Draw S samples (default: one, shape (n,)) from the Vecchia-
    approximated N(0, scale*K) by blocked ancestral sampling; ``gen`` is a
    torch.Generator on X's device.  ``parts`` as in `cond_weights`."""
    n = X.shape[0]
    squeeze = S is None
    S_ = 1 if squeeze else S
    w, sigma, idx_asc, _ = cond_weights(X, NNarray, length, nugget, name, parts=parts)
    eps = (torch.randn((S_, n), generator=gen, dtype=X.dtype, device=X.device)
           * torch.sqrt(torch.as_tensor(scale, dtype=X.dtype, device=X.device))
           * sigma[None, :])
    x = ancestral_sample(eps, w, idx_asc)
    return x[0] if squeeze else x


def post_het_vecch(gen, X, impNN, Gamma, y_eff, scale, length, nugget, name,
                   normals=None):
    """One draw from the exact conditional posterior of the Hetero mean
    under the Vecchia approximation (reference `U_matrix_sp` +
    `post_het_vecch`, dgpsi/vecchia.py:612-622, likelihood_class.py:153-182),
    batched over the points.

    Model: f ~ N(0, scale*K) (Vecchia-approximated), y_i = f_i + N(0,
    Gamma_i).  The reference stacks (observations, latents) into a 2n
    sequence and Vecchia-factorises the joint: column i conditions latent
    f_i on its own observation y_i, the PRIOR latents among its m-1 nearest
    neighbours, and the observations of its FUTURE neighbours.  With u_i =
    L_i^{-T} e_last the sparse factor satisfies  f | y ~ N(-U_l^{-T} U_o^T y,
    U_l^{-T} U_l^{-1}).  The upper-triangular solve has the form of the
    ancestral recursion, so it runs through the blocked `ancestral_sample`.

    All inputs in Vecchia order; returns an (n,) sample in the same order.
    The n blocks of (m+1, m+1) factor in one batched library Cholesky.

    Args:
        gen: torch.Generator on X's device, the source of the n normals
            unless ``normals`` (n,) brings them.
        X: (n, d) ordered inputs.  impNN: (n, m-1) self-excluded NN indices.
        Gamma: (n,) noise variances.  y_eff: (n,) effective observations.
    """
    n = X.shape[0]
    dt = X.dtype
    ar = torch.arange(n, device=X.device)
    is_prev = impNN < ar[:, None]
    idx = torch.cat([impNN, ar[:, None], ar[:, None]], dim=1)        # (n, m+1)
    # slot s is a latent copy if it is a PRIOR neighbour, or the final self slot
    is_lat = torch.cat([is_prev, torch.zeros((n, 1), dtype=torch.bool, device=X.device),
                        torch.ones((n, 1), dtype=torch.bool, device=X.device)], dim=1)
    Xi = X[idx]
    scale = torch.as_tensor(scale, dtype=dt, device=X.device)
    K = scale * kops.k_cross(Xi, Xi, length, name)
    jitter = torch.clamp(_f32_jitter(dt) * scale, min=1e-10)
    diag = (torch.diagonal(K, dim1=-2, dim2=-1)
            + torch.where(is_lat, 0.0, Gamma[idx]) + jitter)
    L = linalg.chol_small(kops.set_diag(K, diag))
    e_last = torch.zeros((n, idx.shape[1]), dtype=dt, device=X.device)
    e_last[:, -1] = 1.0
    u = linalg.bwd_solve_small(L, e_last)            # (n, m+1) = L^{-T} e_last

    # b_i = -(U_o^T y)_i + eps_i  over observation slots
    obs_contrib = torch.sum(torch.where(is_lat, 0.0, u * y_eff[idx]), dim=1)
    eps = normals if normals is not None else torch.randn(
        (n,), generator=gen, dtype=dt, device=X.device)
    u_self = u[:, -1]
    b = (-obs_contrib + eps) / u_self
    # prior-latent slots (the first m-1 NN entries) drive the recursion
    w = torch.where(is_prev, -u[:, :impNN.shape[1]] / u_self[:, None], 0.0)
    idx_prev = torch.where(is_prev, impNN, 0)
    return ancestral_sample(b[None, :], w, idx_prev)[0]


# ----------------------------------------------------------------------
# predictions
# ----------------------------------------------------------------------
def _pred_blocks(x, w_train, NNarray, y, length, nugget, nugget_diag, name):
    """(M, m+1, m+1) blocks: [train NN ascending..., test point last]."""
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
    K = kops.set_diag(K, torch.where(valid_full, 1.0 + nug + _f32_jitter(K.dtype), 1.0))
    return K, yi


def gp_vecch(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
             extra_jit=0.0):
    """Batched Vecchia GP prediction (reference gp_vecch).  ``extra_jit`` is
    an additional diagonal for the callers' jitter-escalation retry.  On the
    card inside K6's bound (blocks of k + 1 <= 64 rows) one K6 launch
    (`cuda_pred.gp_vecch_t`); else `gp_vecch_plain`, on the CPU and as the
    large-block route."""
    if cv.launches("K6", x, NNarray.shape[1] + 1, x.shape[1]):
        return cpred.gp_vecch_t(x, w_train, NNarray, y, scale, length, nugget, nugget_diag,
                                name, extra_jit, jitter=_f32_jitter(x.dtype))
    return gp_vecch_plain(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
                          extra_jit)


def gp_vecch_plain(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
                   extra_jit=0.0):
    """Plain version of K6's kriging: `gp_vecch` in batched torch.linalg."""
    K, yi = _pred_blocks(x, w_train, NNarray, y, length, nugget, nugget_diag, name)
    K = K + extra_jit * _eye_like(K)
    L = linalg.chol_small(K)
    Ly = linalg.fwd_solve_small(L[:, :-1, :-1], yi)
    mean = torch.einsum('ij,ij->i', L[:, -1, :-1], Ly)
    var = scale * L[:, -1, -1] ** 2
    return mean, var


def loo_gp_vecch(x, NNarray, y, scale, length, nugget, nugget_diag, name,
                 extra_jit=0.0):
    """Batched LOO under Vecchia (reference loo_gp_vecch): NNarray rows are
    self-inclusive NN (self first); the block is reversed so self sits last
    and is predicted from the others."""
    rev = torch.flip(NNarray, dims=(1,))
    valid = rev >= 0
    safe = torch.where(valid, rev, 0)
    Xi = x[safe]
    yi = torch.where(valid, y[safe], 0.0)
    nug = nugget * nugget_diag[safe]
    K = kops.k_cross(Xi, Xi, length, name)
    both = valid[:, :, None] & valid[:, None, :]
    K = torch.where(both, K, _eye_like(K))
    K = kops.set_diag(K, torch.where(valid, 1.0 + nug + _f32_jitter(K.dtype), 1.0))
    K = K + extra_jit * _eye_like(K)
    L = linalg.chol_small(K)
    Ly = linalg.fwd_solve_small(L[:, :-1, :-1], yi[:, :-1])
    mean = torch.einsum('ij,ij->i', L[:, -1, :-1], Ly)
    var = scale * L[:, -1, -1] ** 2
    return mean, var


def link_gp_vecch(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget,
                  nugget_diag, name, extra_jit=0.0):
    """Batched linked-GP prediction under Vecchia (reference link_gp_vecch):
    per test point, closed-form I/J moments over its conditioning set.  On
    the card inside K6's bound (k <= 64 neighbours) one K6 launch
    (`cuda_pred.link_gp_vecch_t`); else `link_gp_vecch_plain`, on the CPU
    and as the large-block route."""
    if cv.launches("K6", m, NNarray.shape[1], m.shape[1] + (0 if z is None else z.shape[1])):
        return cpred.link_gp_vecch_t(m, v, z, w1, global_w1, NNarray, y, scale, length,
                                     nugget, nugget_diag, name, extra_jit,
                                     jitter=_f32_jitter(m.dtype))
    return link_gp_vecch_plain(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget,
                               nugget_diag, name, extra_jit)


def link_gp_vecch_plain(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget,
                        nugget_diag, name, extra_jit=0.0):
    """Plain version of K6's linked instantiation: `link_gp_vecch` in
    batched torch.  The JAX package vmaps a one-point function; here the
    points are a batch axis."""
    from ..ops import moments

    Dw = w1.shape[1]
    Dz = 0 if z is None else z.shape[1]
    full_len = torch.broadcast_to(length, (Dw + Dz,))
    length_w, length_z = full_len[:Dw], full_len[Dw:]

    ok = NNarray >= 0                                     # (M, k)
    idx = torch.where(ok, NNarray, 0)
    wi = w1[idx]                                          # (M, k, Dw)
    yi = torch.where(ok, y[idx], 0.0)
    nug_i = nugget * nugget_diag[idx] + extra_jit
    I, J = moments.IJ(wi, m, v, length_w, name)
    if z is not None:
        gwi = global_w1[idx]
        Iz = kops.k_vec(gwi, z, length_z, name)           # (M, k)
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
    K = kops.set_diag(K, torch.where(ok, 1.0 + nug_i + _f32_jitter(K.dtype), 1.0))
    L = linalg.chol_small(K)
    Rinv_y = linalg.bwd_solve_small(L, linalg.fwd_solve_small(L, yi))
    # tr(K^-1 J) = tr(L^-1 J L^-T)
    A = torch.linalg.solve_triangular(L, J, upper=False)
    N = torch.linalg.solve_triangular(L, A.transpose(-1, -2), upper=False)
    tr = torch.diagonal(N, dim1=-2, dim2=-1).sum(-1)
    mu = torch.sum(I * Rinv_y, dim=-1)
    var = torch.abs(linalg.quad_form(J, Rinv_y) - mu**2
                    + scale * (1.0 + nugget - tr))
    return mu, var
