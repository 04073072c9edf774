"""Batched SEM M-step: the bounded L-BFGS of every GP node of a group runs
as one batched optimisation; the counterpart of `dgp_tpu/models/mstep.py`.

The reference optimises each node's hyper-parameters independently
(dgpsi/dgp.py:1391-1398).  The node problems are tiny (1-3 parameters) and
independent, so all nodes of a compatible group share every objective
evaluation: one K1 launch evaluates the objective and gradient of every
node (`ops.cuda_vecchia.block_nllik_grad_parts_t`), and `ops.lbfgs`
carries G problems as tensors.

Nodes differ in input dimension, parameter count (isotropic vs per-dim
lengthscales, estimated vs fixed nugget), priors and replicate handling.
These are unified so that a group shares one batched objective:

  * input dims are zero-padded to the group's largest (zero coordinates
    contribute nothing to stationary kernels);
  * the kernel differentiates with respect to ALL padded per-dim
    log-lengths plus the log-nugget; a per-node tying matrix A maps the
    node's own parameter vector lt (p_max, padded with frozen lanes) to the
    full lane vector, and A^T contracts the full gradient back (an
    isotropic length is tied lanes);
  * scale profiling and replicate corrections use per-node flags: with
    sum_res = 0 and n_orig = n the replicate terms vanish;
  * ga and inv_ga priors are evaluated per lane and selected by a
    per-node prior id; the 'ref' prior works on the expanded per-dim
    lengths and the nugget lane with a zero-padded characteristic length.

Groups are keyed by (mode, kernel name, m + 1): Vecchia groups evaluate
every objective and gradient through one K1 launch, or, where K1's bound
refuses the group's blocks, through the large-block route of
`vecchia.core` (the gradient by autograd, as the JAX package's
`_vecch_nll_xla`); dense groups (m + 1 = 0) factor the G nodes' (n, n)
matrices in one batched Cholesky and take the gradient from autograd.
"""
import torch

from .. import gp_core
from ..ops import cuda_vecchia as cv
from ..ops import kernels as kops
from ..ops import lbfgs, linalg
from ..vecchia import core as vcore

#: prior ids of the per-node selector (0: no prior)
PRIOR_ID = {'ga': 1, 'inv_ga': 2, 'ref': 3}


def _prior_lp(lt, op, ref_lanes):
    """Log-prior of each node and its gradient with respect to the node's
    parameters, in closed form: lt (G, p_max) -> ((G,), (G, p_max)).  ga
    and inv_ga act on the node's own (masked) lanes; 'ref' on the full
    lanes ``ref_lanes`` = (lengths (G, d_max), nugget (G,)) of lt,
    contracted back through the tying matrix.  ``ref_lanes`` is None for a
    group without a 'ref' node, which skips that term."""
    mask = op['param_mask']
    c0, c1 = op['prior_coef'][:, :1], op['prior_coef'][:, 1:]
    lt_safe = lt * mask
    pid = op['prior_id'][:, None]
    lp = torch.zeros_like(lt)
    dlp = torch.zeros_like(lt)
    for name in ('ga', 'inv_ga'):
        v, dv = vcore.prior_lanes(lt_safe, name, c0, c1)
        lp = torch.where(pid == PRIOR_ID[name], v, lp)
        dlp = torch.where(pid == PRIOR_ID[name], dv, dlp)
    lp, dlp = (mask * lp).sum(-1), mask * mask * dlp
    if ref_lanes is None:
        return lp, dlp
    length_full, nugget = ref_lanes
    ref, dlen, dnug = gp_core.ref_prior_lanes(length_full, nugget, op['cl'],
                                              c0[:, 0], c1[:, 0])
    dref = torch.einsum('gfp,gf->gp', op['A'],
                        torch.cat([dlen, dnug[:, None]], dim=1))
    is_ref = pid[:, 0] == PRIOR_ID['ref']
    return (torch.where(is_ref, ref, lp),
            torch.where(is_ref[:, None], dref, dlp))


def _assemble(logdet, quad, nugget64, op, n):
    """Profiled nll and scale (G,) from (logdet, quad) block sums (all
    float64).  Replicate terms vanish when sum_res == 0 and n_orig == n."""
    N = op['n_orig']
    sr = op['sum_res']
    scale_prof = (quad + sr / nugget64) / N
    scale = torch.where(op['scale_est'], scale_prof, op['fixed_scale64'])
    nll = torch.where(op['scale_est'],
                      0.5 * (logdet + N * torch.log(scale_prof)),
                      0.5 * (logdet + quad / scale))
    extra = torch.where(op['scale_est'],
                        0.5 * (N - n) * torch.log(nugget64),
                        0.5 * (sr / (scale * nugget64) + (N - n) * torch.log(nugget64)))
    return nll + op['nug_est_f'] * extra, scale


def _exp_lanes(lt_full):
    """Log-lanes (..., d_max + 1) -> lengths (..., d_max) and nugget (...)."""
    return torch.exp(lt_full[..., :-1]), torch.exp(lt_full[..., -1])


def _lanes(lt, op):
    """Node parameters (G, p_max) -> full lanes: lengths (G, d_max) and
    nugget (G,)."""
    return _exp_lanes(torch.einsum('gfp,gp->gf', op['A'], lt) + op['b'])


def _block_parts(blk, lt_full, start, *, name, d_max, route):
    """Per-point (logdet, quad, dlogdet, dquad) of the points start.. whose
    blocks ``blk`` holds (Xg_raw, yg, nug_g, valid), at the full lanes
    lt_full: one K1 launch, or with ``route`` the large-block route."""
    if route:
        return vcore.nllik_grad_route(blk['Xg_raw'], blk['yg'], blk['nug_g'],
                                      blk['valid'], lt_full, _exp_lanes, name)
    length_full, nugget = _exp_lanes(lt_full)
    Xg, diag, dnug = cv.scale_blocks_t(blk['Xg_raw'], blk['nug_g'], blk['valid'],
                                       length_full, nugget,
                                       vcore._f32_jitter(blk['Xg_raw'].dtype), start)
    return cv.block_nllik_grad_parts_t(Xg, blk['yg'], diag, dnug, name=name,
                                       n_length=d_max, nugget_est=True)


def _vecch_fg(lt, op, parts, split, *, name, d_max, n, has_ref, route=False):
    """(nll (G,), grad (G, p_max), scale (G,)) of every node of the group
    through one K1 launch per share of ``split`` (`parallel.mesh.Split`),
    or with ``route`` through the large-block route.  ``parts`` holds the
    blocks of each share on its device (Xg_raw, yg, nug_g, valid) in the
    kernels' transposed (G, m1, ..., n) layout, ``op`` the other operands;
    ``has_ref`` says whether a node of the group has the 'ref' prior."""
    lt_full = torch.einsum('gfp,gp->gf', op['A'], lt) + op['b']
    length_full, nugget = _exp_lanes(lt_full)
    kw = dict(name=name, d_max=d_max, route=route)
    ld, q, dld, dq = split.gathered(
        lambda dev, sl, blk, lanes: _block_parts(blk, lanes, sl.start, **kw),
        parts, split.copies(lt_full))
    logdet, quad = linalg.sum64(ld, dim=-1), linalg.sum64(q, dim=-1)
    dlogdet, dquad = linalg.sum64(dld, dim=-1), linalg.sum64(dq, dim=-1)
    nugget64 = nugget.to(torch.float64)
    nll, scale = _assemble(logdet, quad, nugget64, op, n)
    g_full = 0.5 * (dlogdet - dquad / scale[:, None])
    g_last = op['nug_est_f'] * 0.5 * (-op['sum_res'] / (scale * nugget64)
                                      + (op['n_orig'] - n))
    g_full = torch.cat([g_full[:, :-1], (g_full[:, -1] + g_last)[:, None]], dim=1)
    g_node = torch.einsum('gfp,gf->gp', op['A'].to(torch.float64), g_full).to(lt.dtype)
    lp, dlp = _prior_lp(lt, op, (length_full, nugget) if has_ref else None)
    return nll - lp, g_node - dlp, scale


def _dense_fg(lt, op, *, name, n, has_ref):
    """(nll (G,), grad (G, p_max), scale (G,)) of every dense node of the
    group (gp_core.neg_log_lik semantics with per-node flags): one batched
    plain Cholesky of the (G, n, n) matrices, the likelihood's gradient by
    autograd, the prior's in closed form.  A matrix that is not positive
    definite gives a NaN objective, which fails the L-BFGS Armijo test (the
    JAX package's dense M-step has no jitter retry either)."""
    with torch.enable_grad():
        lt_ = lt.detach().requires_grad_(True)
        length_full, nugget = _lanes(lt_, op)
        K = kops.k_matrix(op['X'], length_full[:, None, :], nugget[:, None], name,
                          op['w_diag'])
        L = linalg.cholesky(K)
        logdet = linalg.logdet_from_chol(L)
        Kinv_y = linalg.cho_solve(L, op['y'][..., None])[..., 0]
        quad = linalg.sum64(op['y'] * Kinv_y, dim=-1)
        nll, scale = _assemble(logdet, quad, nugget.to(torch.float64), op, n)
        g, = torch.autograd.grad(nll.sum(), lt_)
    lp, dlp = _prior_lp(lt, op, (length_full.detach(), nugget.detach())
                        if has_ref else None)
    return nll.detach() - lp, g - dlp, scale.detach()


def run_group(ops, lt0, lb, ub, maxfun, *, name, mode, d_max, n, has_ref, parts=None,
              split=None):
    """Batched bounded L-BFGS over one node group.

    Args:
        ops: dict of stacked per-node operands (leading axis G).
        mode: 'vecch' (operands in the kernels' block layout) or 'dense'
            (the node inputs X (G, n, d_max), y and w_diag (G, n)).
        lt0/lb/ub: (G, p_max) initial log-params and box bounds.
        maxfun: G per-node function-evaluation budgets (host ints).
        has_ref: whether a node of the group has the 'ref' prior (decided
            on the host, so that other groups skip its lanes).
        parts, split: a Vecchia group's blocks, one dict per share of the
            split (`parallel.mesh.Split`), each on its share's device.
    Returns:
        (lt (G, p_max), scale (G,), ok (G,)), ``ok`` marking a finite result.
    """
    if mode == 'dense':
        def fg(lt):
            return _dense_fg(lt, ops, name=name, n=n, has_ref=has_ref)
    else:
        # K1 or the large-block route, decided from the blocks' shape
        m1 = parts[0]['Xg_raw'].shape[-3]
        route = not cv.use_kernel("K1", m1, d_max, parts[0]['Xg_raw'].dtype)

        def fg(lt):
            return _vecch_fg(lt, ops, parts, split, name=name, d_max=d_max, n=n,
                             has_ref=has_ref, route=route)

    # history=4: the node problems have 1-3 parameters, so a short curvature
    # memory loses nothing.  The profiled scale rides along as aux.
    lt, _, _, scale = lbfgs.minimize(fg, lt0, lb, ub, maxiter=100, maxfun=maxfun,
                                     history=4, has_aux=True)
    ok = torch.isfinite(lt).all(-1) & torch.isfinite(scale)
    return lt, scale, ok
