"""The heteroskedastic Gaussian likelihood and the exact Gibbs draw of its
mean, written out plainly in PyTorch: the benchmark's reference for the
likelihood layer of a DGP whose last hidden layer holds a mean node and a
log-variance node under a ``Hetero`` node.  It imports torch, math and its
sibling modules alone: nothing of the port and nothing of the JAX package.

The density is dgpsi's ``Hetero.llik`` (likelihood_class.py:92): y_i ~
N(f1_i, exp(f2_i)), one observation a site (no replicates).

The exact draw is dgpsi's ``U_matrix_sp`` + ``post_het_vecch``
(dgpsi/vecchia.py:612-622, likelihood_class.py:153-182): the joint of the
observations y and the mean's latents f, observations first, is
Vecchia-factorised as Q = U U^T with U upper triangular.  The column of
latent f_i conditions it on its own observation y_i, on the latents f_j of
its neighbours that come before it in the ordering, and on the
observations y_j of those that come after it.  With U_ff the rows of the
latents and U_yf those of the observations (both over the latents'
columns), f | y has precision U_ff U_ff^T and mean -U_ff^{-T} U_yf^T y, so

    f = U_ff^{-T} (z - U_yf^T y),   z ~ N(0, I).

Here U_ff and U_yf are built as dense (n, n) matrices, one column per
point from the Cholesky factor of its conditioning block, and the draw is
one `torch.linalg.solve_triangular`.

Departures from dgpsi, all of them the port's reading of it: the latents'
prior covariance is scale times the correlation with no nugget on its
diagonal, and every slot of a block carries a diagonal ``jitter`` (1e-10,
the port's floor in float64) besides the observations' noise variances.
With a conditioning set of every other point and no jitter the draw is
exact: it follows the dense Gaussian conditional of f ~ N(0, S) given y =
f + N(0, diag(Gamma)) (`dense_conditional`); the jitter moves it by about
the jitter over the noise variances.
"""
import math

import torch

from . import vecchia as ref

LOG_2PI = math.log(2.0 * math.pi)
#: the diagonal jitter of every slot of a conditioning block
JITTER = 1e-10


def loglik(mean, logvar, y):
    """Hetero log-density of the observations y (n,) given the mean and
    log-variance columns (..., n): the sum over the sites of log N(y_i;
    mean_i, exp(logvar_i)), with the leading axes of the columns."""
    r = y - mean
    return -0.5 * (LOG_2PI + logvar + r * r * torch.exp(-logvar)).sum(-1)


def u_factor(X, impNN, Gamma, scale, length, name, jitter=JITTER):
    """The latents' columns of the joint's upper factor, (U_ff, U_yf), each
    (n, n), in the Vecchia ordering of the (n, d) inputs X.  ``impNN`` (n,
    q) holds each point's neighbours among all the others (not itself);
    ``Gamma`` (n,) the observations' noise variances."""
    n, q = impNN.shape
    dev, dt = X.device, X.dtype
    ar = torch.arange(n, device=dev)
    # slots: the q neighbours, the point's observation, the point's latent
    idx = torch.cat([impNN, ar[:, None], ar[:, None]], dim=1)
    before = impNN < ar[:, None]
    is_lat = torch.cat([before, torch.zeros((n, 1), dtype=torch.bool, device=dev),
                        torch.ones((n, 1), dtype=torch.bool, device=dev)], dim=1)
    Xi = X[idx]
    K = scale * ref.corr(Xi, Xi, length, name)
    noise = torch.where(is_lat, torch.zeros_like(Gamma[idx]), Gamma[idx])
    K = K + torch.diag_embed(noise + jitter)
    L = torch.linalg.cholesky(K)
    e_last = torch.zeros((n, q + 2, 1), dtype=dt, device=dev)
    e_last[:, -1, 0] = 1.0
    # the column of point i: L_i^{-T} e_last, spread over its slots' rows
    u = torch.linalg.solve_triangular(L.transpose(-1, -2), e_last, upper=True)[..., 0]
    cols = ar[:, None].expand(n, q + 2)
    U_ff = torch.zeros((n, n), dtype=dt, device=dev)
    U_yf = torch.zeros((n, n), dtype=dt, device=dev)
    U_ff[idx[is_lat], cols[is_lat]] = u[is_lat]
    U_yf[idx[~is_lat], cols[~is_lat]] = u[~is_lat]
    return U_ff, U_yf


def exact_draw(X, impNN, Gamma, y, scale, length, name, normals, jitter=JITTER):
    """The exact conditional draw of the mean's latents (n,) from the
    normals z (n,), all in the Vecchia ordering: U_ff^{-T} (z - U_yf^T y)."""
    U_ff, U_yf = u_factor(X, impNN, Gamma, scale, length, name, jitter)
    rhs = normals - U_yf.T @ y
    return torch.linalg.solve_triangular(U_ff.T, rhs[:, None], upper=False)[:, 0]


def factor_conditional(U_ff, U_yf, y):
    """(mean, covariance) of f | y under the factor: -U_ff^{-T} U_yf^T y and
    (U_ff U_ff^T)^{-1}."""
    Uinv_T = torch.linalg.solve_triangular(
        U_ff.T, torch.eye(U_ff.shape[0], dtype=U_ff.dtype, device=U_ff.device), upper=False)
    return -Uinv_T @ (U_yf.T @ y), Uinv_T @ Uinv_T.T


def dense_conditional(S, Gamma, y):
    """(mean, covariance) of f | y for f ~ N(0, S) and y = f + N(0,
    diag(Gamma)): S (S + G)^{-1} y and S - S (S + G)^{-1} S."""
    C = torch.linalg.cholesky(S + torch.diag(Gamma))
    A = torch.cholesky_solve(S, C)                 # (S + G)^{-1} S
    return A.T @ y, S - S @ A
