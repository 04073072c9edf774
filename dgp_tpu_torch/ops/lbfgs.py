"""Bounded L-BFGS for the M-step, batched over G independent problems; the
counterpart of `dgp_tpu/ops/lbfgs.py`.

A projected L-BFGS with Armijo backtracking (the reference drives each GP
node's update with scipy's L-BFGS-B under a function-evaluation budget,
`dgpsi/kernel_class.py:516-578`):

  * two-loop recursion over a fixed-size history (newest row first),
  * curvature-guarded history updates,
  * box bounds handled by projection (clip) of iterates,
  * a function-evaluation budget per problem.

Each iteration of the loop is exactly one evaluation of ``fun`` on all G
problems at once (one kernel launch on the M-step path), with the
line-search state (direction, trial step, backtrack count) carried per
problem.  The JAX package vmaps a `lax.while_loop`; here the loop runs
``max(maxfun)`` times and a per-problem mask freezes the problems whose
loop condition has failed, which is what the vmapped `while_loop` does, so
each problem's iterates and ``nfev`` are the ones its own loop would give.
The loop body never reads a value back to the host.

NaN-robust: a non-finite candidate value fails the Armijo test and the step
keeps backtracking; if no progress is possible, the best iterate seen is
returned.

Each evaluation is an ``lbfgs.eval`` span (`tracing`), counted in
``lbfgs.evals``.
"""
import torch

from .. import tracing


def _sel(mask, a, b):
    """where(mask, a, b) with a (G,) mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt((a * a).sum(-1))


def minimize(fun, x0, lb=None, ub=None, maxiter=100, maxfun=30, history=8,
             gtol=1e-5, c1=1e-4, max_ls=20, has_aux=False):
    """Minimise G independent problems from ``x0`` (G, p) in boxes
    ``lb``/``ub`` ((G, p), broadcastable, or None).

    ``fun`` maps x (G, p) to ``(value (G,), grad (G, p))`` or, with
    ``has_aux``, ``(value, grad, aux)`` with aux a (G, ...) tensor.
    ``maxfun`` is an int or a sequence of G ints (host values: the loop
    length is their maximum).

    Returns:
        (x_best, f_best, nfev) or (x_best, f_best, nfev, aux_best); aux_best
        tracks x_best, so callers need no extra evaluation to recover
        by-products (e.g. the profiled scale) at the solution.
    """
    G, p = x0.shape
    dtype, dev = x0.dtype, x0.device
    big = torch.finfo(dtype).max / 4
    lb = (torch.full((G, p), -big, dtype=dtype, device=dev) if lb is None
          else torch.broadcast_to(torch.as_tensor(lb, dtype=dtype, device=dev), (G, p)))
    ub = (torch.full((G, p), big, dtype=dtype, device=dev) if ub is None
          else torch.broadcast_to(torch.as_tensor(ub, dtype=dtype, device=dev), (G, p)))
    mf_host = [int(maxfun)] * G if isinstance(maxfun, int) else [int(v) for v in maxfun]
    if len(mf_host) != G or min(mf_host) < 1:
        raise ValueError(f"maxfun must hold {G} budgets of at least 1, got {mf_host}")
    mf = torch.tensor(mf_host, device=dev)
    eps = 1e-12

    def project(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def two_loop(g, S, Y, rho, gamma):
        # rho == 0 rows contribute nothing, so stale slots are no-ops
        q = g
        alphas = []
        for i in range(history):
            a = rho[:, i] * _dot(S[:, i], q)
            q = q - a[:, None] * Y[:, i]
            alphas.append(a)
        r = gamma[:, None] * q
        for j in range(history - 1, -1, -1):
            b = rho[:, j] * _dot(Y[:, j], r)
            r = r + S[:, j] * (alphas[j] - b)[:, None]
        return r

    def new_direction(x, g, S, Y, rho, gamma, first):
        # zero the gradient components, then the direction components,
        # that push outside an active bound
        at_lb = (x - lb <= eps) & (g > 0)
        at_ub = (ub - x <= eps) & (g < 0)
        gm = g * torch.where(at_lb | at_ub, 0.0, 1.0).to(dtype)
        d = -two_loop(gm, S, Y, rho, gamma)
        out_lb = (x - lb <= eps) & (d < 0)
        out_ub = (ub - x <= eps) & (d > 0)
        d = d * torch.where(out_lb | out_ub, 0.0, 1.0).to(dtype)
        # steepest descent where the direction is not a descent one
        d = _sel(_dot(gm, d) < 0, d, -gm)
        one = torch.ones((), dtype=dtype, device=dev)
        t0 = torch.where(first, torch.minimum(one, 1.0 / (1.0 + _norm(g))), one)
        return d, t0

    def fn(x):
        tracing.count("lbfgs.evals")
        with tracing.span("lbfgs.eval"):
            out = fun(x)
        return out if has_aux else (out[0], out[1], None)

    x = project(x0)
    zeros_i = torch.zeros(G, dtype=torch.int64, device=dev)
    st = dict(x=x, g=torch.zeros_like(x),
              S=torch.zeros((G, history, p), dtype=dtype, device=dev),
              Y=torch.zeros((G, history, p), dtype=dtype, device=dev),
              rho=torch.zeros((G, history), dtype=dtype, device=dev),
              gamma=torch.ones(G, dtype=dtype, device=dev),
              d=torch.zeros_like(x), t=torch.zeros(G, dtype=dtype, device=dev),
              trials=zeros_i, it=zeros_i, nfev=zeros_i,
              done=torch.zeros(G, dtype=torch.bool, device=dev), x_best=x)
    # f = inf marks "not yet evaluated": the first trial at x0 is accepted
    # unconditionally and seeds f and g
    st['f'] = st['f_best'] = st['aux_best'] = None

    for _ in range(max(mf_host)):
        active = ~st['done'] & (st['it'] < maxiter) & (st['nfev'] < mf)
        x_trial = project(st['x'] + st['t'][:, None] * st['d'])
        f_trial, g_trial, aux_trial = fn(x_trial)   # the only evaluation site
        if st['f'] is None:
            inf = torch.full_like(f_trial, float('inf'))
            st['f'] = st['f_best'] = inf
            st['aux_best'] = None if aux_trial is None else torch.zeros_like(aux_trial)
        armijo = f_trial <= st['f'] + c1 * _dot(st['g'], x_trial - st['x'])
        accept = armijo & torch.isfinite(f_trial)
        first = st['nfev'] == 0

        s = x_trial - st['x']
        y = g_trial - st['g']
        sy = _dot(s, y)
        curv_ok = sy > 1e-10 * _norm(s) * _norm(y)
        upd = accept & ~first & curv_ok & torch.isfinite(y).all(-1)
        S = _sel(upd, torch.cat([s[:, None], st['S'][:, :-1]], dim=1), st['S'])
        Y = _sel(upd, torch.cat([y[:, None], st['Y'][:, :-1]], dim=1), st['Y'])
        rho_new = torch.cat([(1.0 / torch.where(upd, sy, 1.0))[:, None],
                             st['rho'][:, :-1]], dim=1)
        rho = _sel(upd, rho_new, st['rho'])
        gamma = torch.where(upd, sy / torch.where(upd, _dot(y, y), 1.0), st['gamma'])

        xa = _sel(accept, x_trial, st['x'])
        fa = torch.where(accept, f_trial, st['f'])
        ga = _sel(accept, g_trial, st['g'])
        d_new, t_new = new_direction(xa, ga, S, Y, rho, gamma, first)
        # rejected: backtrack along the current direction
        d = _sel(accept, d_new, st['d'])
        t = torch.where(accept, t_new, st['t'] * 0.5)
        trials = torch.where(accept, 0, st['trials'] + 1)

        better = accept & (f_trial < st['f_best'])
        pg = project(xa - ga) - xa
        converged = accept & ~first & (pg.abs().amax(-1) < gtol)
        ls_failed = ~accept & (trials > max_ls)
        new = dict(x=xa, f=fa, g=ga, S=S, Y=Y, rho=rho, gamma=gamma, d=d, t=t,
                   trials=trials, it=st['it'] + accept.long(),
                   nfev=st['nfev'] + 1, done=converged | ls_failed,
                   x_best=_sel(better, x_trial, st['x_best']),
                   f_best=torch.where(better, f_trial, st['f_best']),
                   aux_best=(None if aux_trial is None else
                             _sel(better, aux_trial, st['aux_best'])))
        # problems whose loop has ended keep their state
        st = {k: (None if v is None else _sel(active, v, st[k]))
              for k, v in new.items()}

    if has_aux:
        return st['x_best'], st['f_best'], st['nfev'], st['aux_best']
    return st['x_best'], st['f_best'], st['nfev']
