"""One transition of elliptical slice sampling (Murray, Adams and MacKay,
2010), replayed: the benchmark's reference for the I-step's latent draws.
It imports torch and math alone.

From the state f and the prior draw nu, the sampler draws u0 and t0, sets
the threshold log L(f) + log u0 and the first angle 2 pi t0 with the
bracket (theta0 - 2 pi, theta0]; it accepts the first angle whose candidate
f cos(theta) + nu sin(theta) has a log-likelihood above the threshold, and
after each rejection shrinks the bracket to that side of 0 and draws the
next angle inside it.
"""
import math

import torch

TWO_PI = 2.0 * math.pi


def first_uniforms(gen_state):
    """(u0, t0): the transition's first two uniforms, as the sampler draws
    them from its host generator in the captured state."""
    g = torch.Generator()
    g.set_state(gen_state)
    u0, t0 = torch.rand(2, generator=g, dtype=torch.float64).tolist()
    tiny = torch.finfo(torch.float64).tiny
    return tiny + u0 * (1.0 - tiny), t0


def _angle(c, s, hi):
    """The angle of cosine c and sine s in (hi - 2 pi, hi]."""
    t = math.atan2(s, c)
    return t + TWO_PI * math.floor((hi - t) / TWO_PI)


def transition(f, nu, loglik, u0, t0, proposals, tol=1e-9):
    """The latent that one transition from f accepts, and the index of its
    angle among ``proposals``: the (cos, sin) pairs of the angles the
    sampler tried, in order.  The first has to be 2 pi t0, and each later
    one has to lie in the bracket that the reference's rejections leave.
    None where one does not, or where the proposals end before the
    reference accepts one."""
    if not proposals:
        return None
    theta0 = TWO_PI * t0
    c, s = proposals[0]
    if abs((math.atan2(s, c) - theta0 + math.pi) % TWO_PI - math.pi) > tol:
        return None
    log_y = float(loglik(f)) + math.log(u0)
    tmin, tmax = theta0 - TWO_PI, theta0
    for i, (c, s) in enumerate(proposals):
        theta = theta0 if i == 0 else _angle(c, s, tmax)
        if theta < tmin - tol:
            return None
        cand = c * f + s * nu
        if float(loglik(cand)) > log_y:
            return cand, i
        if theta < 0.0:
            tmin = theta
        else:
            tmax = theta
    return None
