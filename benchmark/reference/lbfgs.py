"""A projected L-BFGS with Armijo backtracking for one problem: the
algorithm the model family's M-step runs under a function-evaluation budget
(dgpsi drives scipy's L-BFGS-B with ``maxfun``; the port runs this
projected form, batched over nodes).  Written out plainly for one problem,
so that the benchmark can run an M-step again from the state the program
started it from and compare where the two end.

Each loop pass makes exactly one evaluation: a trial point along the
current direction is accepted on Armijo's condition (the first is always
accepted and seeds the value and gradient) or the step is halved.  The
curvature memory keeps the newest ``history`` pairs that pass a curvature
test; components that push out of an active bound are zeroed; the best
accepted point is returned with its auxiliary output.
"""
import torch


def minimize(fun, x0, lb, ub, maxfun, maxiter=100, history=4, gtol=1e-5, c1=1e-4,
             max_ls=20):
    """Minimise ``fun`` (x (p,) -> (value, gradient (p,), aux)) from x0 in
    the box [lb, ub].  Returns (x_best, f_best, evaluations, aux_best)."""
    dtype, dev = x0.dtype, x0.device
    eps = 1e-12
    p = x0.shape[0]

    def project(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def dot(a, b):
        return (a * b).sum()

    def norm(a):
        return torch.sqrt((a * a).sum())

    S = torch.zeros((history, p), dtype=dtype, device=dev)
    Y = torch.zeros((history, p), dtype=dtype, device=dev)
    rho = torch.zeros(history, dtype=dtype, device=dev)
    gamma = torch.ones((), dtype=dtype, device=dev)

    def direction(x, g, first):
        at_bound = ((x - lb <= eps) & (g > 0)) | ((ub - x <= eps) & (g < 0))
        gm = g * torch.where(at_bound, 0.0, 1.0).to(dtype)
        q = gm
        alphas = []
        for i in range(history):
            a = rho[i] * dot(S[i], q)
            q = q - a * Y[i]
            alphas.append(a)
        r = gamma * q
        for j in range(history - 1, -1, -1):
            b = rho[j] * dot(Y[j], r)
            r = r + S[j] * (alphas[j] - b)
        d = -r
        out = ((x - lb <= eps) & (d < 0)) | ((ub - x <= eps) & (d > 0))
        d = d * torch.where(out, 0.0, 1.0).to(dtype)
        if not bool(dot(gm, d) < 0):
            d = -gm
        one = torch.ones((), dtype=dtype, device=dev)
        t0 = torch.minimum(one, 1.0 / (1.0 + norm(g))) if first else one
        return d, t0

    x = project(x0)
    g = torch.zeros_like(x)
    f = torch.tensor(float("inf"), dtype=dtype, device=dev)
    d = torch.zeros_like(x)
    t = torch.zeros((), dtype=dtype, device=dev)
    trials = it = nfev = 0
    x_best, f_best, aux_best = x, f, None
    while it < maxiter and nfev < maxfun:
        x_trial = project(x + t * d)
        f_trial, g_trial, aux = fun(x_trial)
        accept = bool(f_trial <= f + c1 * dot(g, x_trial - x)) and bool(torch.isfinite(f_trial))
        first = nfev == 0
        s, yv = x_trial - x, g_trial - g
        sy = dot(s, yv)
        if (accept and not first and bool(sy > 1e-10 * norm(s) * norm(yv))
                and bool(torch.isfinite(yv).all())):
            S = torch.cat([s[None], S[:-1]])
            Y = torch.cat([yv[None], Y[:-1]])
            rho = torch.cat([(1.0 / sy)[None], rho[:-1]])
            gamma = sy / dot(yv, yv)
        if accept:
            x, f, g = x_trial, f_trial, g_trial
            d, t = direction(x, g, first)
            trials = 0
            it += 1
        else:
            t = t * 0.5
            trials += 1
        if accept and bool(f_trial < f_best):
            x_best, f_best, aux_best = x_trial, f_trial, aux
        nfev += 1
        pg = project(x - g) - x
        if (accept and not first and bool(pg.abs().max() < gtol)) or (
                not accept and trials > max_ls):
            break
    return x_best, f_best, nfev, aux_best
