"""Elliptical slice sampling with speculative candidate batching; the
counterpart of `dgp_tpu/ess.py`.

The bracket-shrinking recursion (reference `dgpsi/imputation.py:44-119`) is
deterministic given that every earlier candidate was rejected, so K
candidate angles are generated up front per round and their K
log-likelihoods evaluated in one batched call; the first accepted one is
taken.  This is distributionally identical to the sequential sampler and,
fed the same uniforms, accepts the same angle.

The JAX package runs the rejection loop as a `lax.while_loop`.  Here the
bracket (a handful of scalars) lives on the host and each round makes one
host check: the round's K log-likelihoods come back from the device and the
accepted angle goes out.  Only the candidate state f cos + nu sin is
computed on the device.

Each round is a ``sem.ess.round`` span around its evaluation and read
(`tracing.to_host`, cause ``ess_round``), counted in ``ess.rounds`` and
its evaluated states in ``ess.candidates``; each call counts in
``ess.transitions``, and in ``ess.moves`` when it accepts a candidate.
"""
import math

import torch

from . import tracing

_TWO_PI = 2.0 * math.pi


def ess_update(gen, f, nu, log_lik_fn, log_lik_angles=None, spec=4,
               max_steps=1000, return_angle=False, uniform=None):
    """One ESS transition.

    Args:
        gen: torch.Generator on the CPU, the default source of uniforms.
        f: current latent state (tensor, any shape).
        nu: prior draw with the same shape as ``f``.
        log_lik_fn: maps a candidate to a scalar log-likelihood.
        log_lik_angles: optional evaluator mapping (cos (K,), sin (K,)) as
            sequences of floats to the (K,) log-likelihoods of the
            candidates cos*f + sin*nu (see CompiledDGP._plan_ll).
        spec: number of speculative candidates per round.
        uniform: optional source of uniforms, k -> sequence of k floats in
            [0, 1); consumed in the sequential sampler's order.
        return_angle: also return the accepted angle as (cos, sin), which
            is (1, 0) when no candidate was accepted.
    """
    tracing.count("ess.transitions")
    if uniform is None:
        def uniform(k):
            return torch.rand(k, generator=gen, dtype=torch.float64).tolist()
    tiny = torch.finfo(f.dtype).tiny
    u0, t0 = uniform(2)
    u0 = tiny + u0 * (1.0 - tiny)  # u == 0 would accept anything
    theta0 = t0 * _TWO_PI

    def cand(th):
        return f * math.cos(th) + nu * math.sin(th)

    def out(fp, th, done):
        if done:
            tracing.count("ess.moves")
        else:
            fp, th = f, 0.0
        return (fp, (math.cos(th), math.sin(th))) if return_angle else fp

    if spec <= 1:
        def eval_one(x):
            tracing.count("ess.rounds")
            tracing.count("ess.candidates")
            with tracing.span("sem.ess.round"):
                ll = torch.as_tensor(log_lik_fn(x), dtype=torch.float64)
                return float(tracing.to_host(ll, "ess_round"))

        log_y = eval_one(f) + math.log(u0)
        theta, tmin, tmax = theta0, theta0 - _TWO_PI, theta0
        for _ in range(max_steps):
            fp = cand(theta)
            if eval_one(fp) > log_y:
                return out(fp, theta, True)
            if theta < 0.0:
                tmin = theta
            else:
                tmax = theta
            theta = tmin + uniform(1)[0] * (tmax - tmin)
        return out(f, 0.0, False)

    K = int(spec)

    def gen_batch(theta, tmin, tmax):
        """K speculative angles under the all-rejected bracket recursion,
        and the angle that follows them."""
        thetas = []
        for u in uniform(K):
            thetas.append(theta)
            if theta < 0.0:
                tmin = theta
            else:
                tmax = theta
            theta = tmin + u * (tmax - tmin)
        return thetas, theta

    def eval_cands(thetas, with_current):
        cos_v = [math.cos(t) for t in thetas]
        sin_v = [math.sin(t) for t in thetas]
        if with_current:
            cos_v, sin_v = [1.0] + cos_v, [0.0] + sin_v
        tracing.count("ess.rounds")
        tracing.count("ess.candidates", len(cos_v))
        with tracing.span("sem.ess.round"):
            if log_lik_angles is not None:
                lls = log_lik_angles(cos_v, sin_v)
            else:
                lls = torch.stack([torch.as_tensor(log_lik_fn(f * c + nu * s))
                                   for c, s in zip(cos_v, sin_v)])
            return tracing.to_host(torch.as_tensor(lls).double(), "ess_round").tolist()

    theta, tmin, tmax = theta0, theta0 - _TWO_PI, theta0
    log_y = None
    rounds = 0
    while rounds * K < max_steps:
        thetas, theta_next = gen_batch(theta, tmin, tmax)
        lls = eval_cands(thetas, with_current=log_y is None)
        if log_y is None:
            log_y = lls[0] + math.log(u0)
            lls = lls[1:]
        rounds += 1
        for th, ll in zip(thetas, lls):
            if ll > log_y:
                return out(cand(th), th, True)
            # rejected: shrink the bracket as the sequential sampler does
            if th < 0.0:
                tmin = th
            else:
                tmax = th
        theta = theta_next
    return out(f, 0.0, False)
