"""Closed-form linked-GP moments; the counterpart of `dgp_tpu/ops/moments.py`.

For a GP with training inputs X and a Gaussian test input
w ~ N(z_m, diag(z_v)), per kernel dimension and in product across them:

    I_i     = E_w[ k(w, X_i) ]                       (n,)
    J_ij    = E_w[ k(w, X_i) k(w, X_j) ]             (n, n)

for the sexp and separable Matern-2.5 kernels.  Where the JAX package
vmaps a one-point function, these take leading batch dimensions: X is
(..., n, d), z_m and z_v are (..., d).  Dimensions with z_v == 0
(deterministic input) fall back to plain kernel evaluations.
"""
import math

import torch

SQRT5 = 2.23606797749978969


def _erf(x):
    return torch.special.erf(x)


def i_sexp(X, z_m, z_v, length):
    l2 = length**2
    c = torch.prod(1.0 / torch.sqrt(1.0 + 2.0 * z_v / l2), dim=-1)
    expo = torch.sum((X - z_m[..., None, :]) ** 2
                     / (2.0 * z_v[..., None, :] + l2), dim=-1)
    return c[..., None] * torch.exp(-expo)


def j_sexp(X, z_m, z_v, length):
    l2 = length**2
    c = torch.prod(1.0 / torch.sqrt(1.0 + 4.0 * z_v / l2), dim=-1)
    Xz = X - z_m[..., None, :]                      # (..., n, d)
    plus = Xz[..., :, None, :] + Xz[..., None, :, :]
    minus = Xz[..., :, None, :] - Xz[..., None, :, :]
    zv = z_v[..., None, None, :]
    expo = torch.sum(plus**2 / (2.0 * l2 + 8.0 * zv) + minus**2 / (2.0 * l2),
                     dim=-1)
    return c[..., None, None] * torch.exp(-expo)


def _i_matern_1d(zX, z_v, length):
    """E_w[k_1d(w, x)] per dimension for w ~ N(0 offset zX = z_m - x, z_v);
    z_v broadcasts against zX."""
    vs = torch.where(z_v > 0.0, z_v, torch.ones_like(z_v))
    muA = zX - SQRT5 * vs / length
    muB = zX + SQRT5 * vs / length
    l2 = length**2
    sq = torch.sqrt(0.5 * vs / math.pi) / length
    partA = torch.exp((5.0 * vs - 2.0 * SQRT5 * length * zX) / (2.0 * l2)) * (
        (1.0 + SQRT5 * muA / length + 5.0 * (muA**2 + vs) / (3.0 * l2))
        * 0.5
        * (1.0 + _erf(muA / torch.sqrt(2.0 * vs)))
        + (SQRT5 + 5.0 * muA / (3.0 * length)) * sq * torch.exp(-0.5 * muA**2 / vs)
    )
    partB = torch.exp((5.0 * vs + 2.0 * SQRT5 * length * zX) / (2.0 * l2)) * (
        (1.0 - SQRT5 * muB / length + 5.0 * (muB**2 + vs) / (3.0 * l2))
        * 0.5
        * (1.0 + _erf(-muB / torch.sqrt(2.0 * vs)))
        + (SQRT5 - 5.0 * muB / (3.0 * length)) * sq * torch.exp(-0.5 * muB**2 / vs)
    )
    stochastic = partA + partB
    a = torch.abs(zX) / length
    deterministic = (1.0 + SQRT5 * a + (5.0 / 3.0) * a**2) * torch.exp(-SQRT5 * a)
    return torch.where(z_v > 0.0, stochastic, deterministic)


def i_matern(X, z_m, z_v, length):
    zX = z_m[..., None, :] - X                      # (..., n, d)
    return torch.prod(_i_matern_1d(zX, z_v[..., None, :], length), dim=-1)


def _pow4(x):
    """x^4 as two squares: on the CPU a general power takes another formula
    for the last elements of a tensor than for the rest, so that a value
    would depend on the size of the batch it was computed in."""
    return torch.square(torch.square(x))


def _jd_matern_1d(X1, X2, z_m, z_v, length):
    """E_w[k_1d(w, X1) k_1d(w, X2)], w ~ N(z_m, z_v), separable Matern-2.5;
    the three-piece closed form of the JAX package, elementwise."""
    x1 = torch.minimum(X1, X2)
    x2 = torch.maximum(X1, X2)
    l, v = length, z_v
    l2, l3 = l**2, l**3
    l4 = _pow4(l)
    sqv = torch.sqrt(0.5 * v / math.pi)
    inv9l4 = 1.0 / (9.0 * l4)

    # piece 1: w < x1 (both kernels on the same side)
    E30 = 1.0 + (
        25.0 * x1**2 * x2**2
        - 3.0 * SQRT5 * (3.0 * l3 + 5.0 * l * x1 * x2) * (x1 + x2)
        + 15.0 * l2 * (x1**2 + x2**2 + 3.0 * x1 * x2)
    ) * inv9l4
    E31 = (
        18.0 * SQRT5 * l3
        + 15.0 * SQRT5 * l * (x1**2 + x2**2)
        - (75.0 * l2 + 50.0 * x1 * x2) * (x1 + x2)
        + 60.0 * SQRT5 * l * x1 * x2
    ) * inv9l4
    E32 = 5.0 * (
        5.0 * x1**2 + 5.0 * x2**2 + 15.0 * l2 - 9.0 * SQRT5 * l * (x1 + x2) + 20.0 * x1 * x2
    ) * inv9l4
    E33 = 10.0 * (3.0 * SQRT5 * l - 5.0 * x1 - 5.0 * x2) * inv9l4
    E34 = 25.0 * inv9l4
    muC = z_m - 2.0 * SQRT5 * v / l
    E3A31 = (
        E30
        + muC * E31
        + (muC**2 + v) * E32
        + (muC**3 + 3.0 * v * muC) * E33
        + (_pow4(muC) + 6.0 * v * muC**2 + 3.0 * v**2) * E34
    )
    E3A32 = (
        E31
        + (muC + x2) * E32
        + (muC**2 + 2.0 * v + x2**2 + muC * x2) * E33
        + (muC**3 + x2**3 + x2 * muC**2 + muC * x2**2 + 3.0 * v * x2 + 5.0 * v * muC) * E34
    )
    P1 = torch.exp((10.0 * v + SQRT5 * l * (x1 + x2 - 2.0 * z_m)) / l2) * (
        0.5 * E3A31 * (1.0 + _erf((muC - x2) / torch.sqrt(2.0 * v)))
        + E3A32 * sqv * torch.exp(-0.5 * (x2 - muC) ** 2 / v)
    )

    # piece 2: x1 < w < x2
    E40 = 1.0 + (
        25.0 * x1**2 * x2**2
        + 3.0 * SQRT5 * (3.0 * l3 - 5.0 * l * x1 * x2) * (x2 - x1)
        + 15.0 * l2 * (x1**2 + x2**2 - 3.0 * x1 * x2)
    ) * inv9l4
    E41 = 5.0 * (
        3.0 * SQRT5 * l * (x2**2 - x1**2) + 3.0 * l2 * (x1 + x2) - 10.0 * x1 * x2 * (x1 + x2)
    ) * inv9l4
    E42 = 5.0 * (
        5.0 * x1**2 + 5.0 * x2**2 - 3.0 * l2 - 3.0 * SQRT5 * l * (x2 - x1) + 20.0 * x1 * x2
    ) * inv9l4
    E43 = -50.0 * (x1 + x2) * inv9l4
    E44 = 25.0 * inv9l4
    E4A41 = (
        E40
        + z_m * E41
        + (z_m**2 + v) * E42
        + (z_m**3 + 3.0 * v * z_m) * E43
        + (_pow4(z_m) + 6.0 * v * z_m**2 + 3.0 * v**2) * E44
    )
    E4A42 = (
        E41
        + (z_m + x1) * E42
        + (z_m**2 + 2.0 * v + x1**2 + z_m * x1) * E43
        + (z_m**3 + x1**3 + x1 * z_m**2 + z_m * x1**2 + 3.0 * v * x1 + 5.0 * v * z_m) * E44
    )
    E4A43 = (
        E41
        + (z_m + x2) * E42
        + (z_m**2 + 2.0 * v + x2**2 + z_m * x2) * E43
        + (z_m**3 + x2**3 + x2 * z_m**2 + z_m * x2**2 + 3.0 * v * x2 + 5.0 * v * z_m) * E44
    )
    P2 = torch.exp(-SQRT5 * (x2 - x1) / l) * (
        0.5 * E4A41 * (_erf((x2 - z_m) / torch.sqrt(2.0 * v))
                       - _erf((x1 - z_m) / torch.sqrt(2.0 * v)))
        + E4A42 * sqv * torch.exp(-0.5 * (x1 - z_m) ** 2 / v)
        - E4A43 * sqv * torch.exp(-0.5 * (x2 - z_m) ** 2 / v)
    )

    # piece 3: w > x2
    E50 = 1.0 + (
        25.0 * x1**2 * x2**2
        + 3.0 * SQRT5 * (3.0 * l3 + 5.0 * l * x1 * x2) * (x1 + x2)
        + 15.0 * l2 * (x1**2 + x2**2 + 3.0 * x1 * x2)
    ) * inv9l4
    E51 = (
        18.0 * SQRT5 * l3
        + 15.0 * SQRT5 * l * (x1**2 + x2**2)
        + (75.0 * l2 + 50.0 * x1 * x2) * (x1 + x2)
        + 60.0 * SQRT5 * l * x1 * x2
    ) * inv9l4
    E52 = 5.0 * (
        5.0 * x1**2 + 5.0 * x2**2 + 15.0 * l2 + 9.0 * SQRT5 * l * (x1 + x2) + 20.0 * x1 * x2
    ) * inv9l4
    E53 = 10.0 * (3.0 * SQRT5 * l + 5.0 * x1 + 5.0 * x2) * inv9l4
    E54 = 25.0 * inv9l4
    muD = z_m + 2.0 * SQRT5 * v / l
    E5A51 = (
        E50
        - muD * E51
        + (muD**2 + v) * E52
        - (muD**3 + 3.0 * v * muD) * E53
        + (_pow4(muD) + 6.0 * v * muD**2 + 3.0 * v**2) * E54
    )
    E5A52 = (
        E51
        - (muD + x1) * E52
        + (muD**2 + 2.0 * v + x1**2 + muD * x1) * E53
        - (muD**3 + x1**3 + x1 * muD**2 + muD * x1**2 + 3.0 * v * x1 + 5.0 * v * muD) * E54
    )
    P3 = torch.exp((10.0 * v - SQRT5 * l * (x1 + x2 - 2.0 * z_m)) / l2) * (
        0.5 * E5A51 * (1.0 + _erf((x1 - muD) / torch.sqrt(2.0 * v)))
        + E5A52 * sqv * torch.exp(-0.5 * (x1 - muD) ** 2 / v)
    )

    return P1 + P2 + P3


def j_matern(X, z_m, z_v, length):
    """(..., n, n) second-moment matrix for the separable Matern-2.5 kernel."""
    zm = z_m[..., None, None, :]
    zv = z_v[..., None, None, :]
    vs = torch.where(zv > 0.0, zv, torch.ones_like(zv))
    Xi = X[..., :, None, :]
    Xj = X[..., None, :, :]
    jd = _jd_matern_1d(Xi, Xj, zm, vs, length)      # (..., n, n, d)
    ifac = _i_matern_1d(z_m[..., None, :] - X, z_v[..., None, :], length)
    det = ifac[..., :, None, :] * ifac[..., None, :, :]
    per_dim = torch.where(zv > 0.0, jd, det)
    return torch.prod(per_dim, dim=-1)


def IJ(X, z_m, z_v, length, name):
    """(I, J) for Gaussian test inputs.

    Args:
        X: (..., n, d) training inputs.
        z_m, z_v: (..., d) test means and variances.
        length: (d,) lengthscales (already broadcast to the full dim).
        name: 'sexp' or 'matern2.5'.
    """
    if name == "sexp":
        return i_sexp(X, z_m, z_v, length), j_sexp(X, z_m, z_v, length)
    if name == "matern2.5":
        return i_matern(X, z_m, z_v, length), j_matern(X, z_m, z_v, length)
    raise ValueError(f"unknown kernel name: {name}")
