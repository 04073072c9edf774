"""Plain predictions of (deep, linked) Gaussian-process emulators in
PyTorch: the benchmark's reference for the port's `emulator.predict` and
`lgp.predict`.  It imports torch and this package's `vecchia` module alone.

  * `gp_vecch`: Vecchia kriging of each query from its neighbour set;
  * `link_vecch`: the linked-GP moments of a Vecchia node under a Gaussian
    input (Kyzyurova et al. 2018; Ming and Guillas 2021), over each query's
    neighbour set;
  * `link_dense`: the same over all training points, for a dense node;
  * `exact_nn`: each query's nearest training points;
  * `mixture`, `gap`: the imputations' mixture, and the comparison.

The squared-exponential moments are written out from their definition:
for w ~ N(m, v) per dimension and k(w, x) = exp(-(w - x)^2 / l^2),
E k(w, x_i) = exp(-(m - x_i)^2 / (l^2 + 2v)) / sqrt(1 + 2v / l^2) and
E k(w, x_i) k(w, x_j) = exp(-2 (m - (x_i + x_j)/2)^2 / (l^2 + 4v)
- (x_i - x_j)^2 / (2 l^2)) / sqrt(1 + 4v / l^2), a product over dimensions.
"""
import torch

from .vecchia import _masked, corr


def exact_nn(q, x, m, chunk=512):
    """Indices (M, m) of the m rows of x nearest each row of q, nearest
    first (both already length-scaled)."""
    out = []
    for s in range(0, q.shape[0], chunk):
        d = ((q[s:s + chunk, None, :] - x[None, :, :]) ** 2).sum(-1)
        out.append(torch.topk(d, m, dim=1, largest=False).indices)
    return torch.cat(out)


def gp_vecch(x, X, NN, y, scale, length, nugget, name):
    """Kriging mean and variance of queries x (M, d) from their neighbours
    NN (M, k) among the training points X (n, d) with targets y (n,)."""
    valid = NN >= 0
    idx = torch.where(valid, NN, 0)
    Xc = X[idx]
    diag = torch.full(valid.shape, 1.0 + nugget, dtype=X.dtype, device=X.device)
    Kcc = _masked(corr(Xc, Xc, length, name), valid, diag)
    kcq = torch.where(valid, corr(Xc, x[:, None, :], length, name)[..., 0], 0.0)
    L = torch.linalg.cholesky(Kcc)
    a = torch.cholesky_solve(kcq[..., None], L)[..., 0]
    mean = (a * torch.where(valid, y[idx], 0.0)).sum(-1)
    var = scale * (1.0 + nugget - (a * kcq).sum(-1))
    return mean, var


def _moments(Xc, m, v, length):
    """I (..., k) and J (..., k, k) of sexp under w ~ N(m, diag v): Xc (...,
    k, D), m and v (..., D)."""
    l2 = length ** 2
    mm, vv = m[..., None, :], v[..., None, :]
    I = (torch.exp(-((mm - Xc) ** 2 / (l2 + 2.0 * vv)).sum(-1))
         / torch.sqrt(1.0 + 2.0 * v / l2).prod(-1)[..., None])
    mid = 0.5 * (Xc[..., :, None, :] + Xc[..., None, :, :])
    gap = Xc[..., :, None, :] - Xc[..., None, :, :]
    vj = v[..., None, None, :]
    expo = (2.0 * (m[..., None, None, :] - mid) ** 2 / (l2 + 4.0 * vj)
            + gap ** 2 / (2.0 * l2)).sum(-1)
    J = torch.exp(-expo) / torch.sqrt(1.0 + 4.0 * v / l2).prod(-1)[..., None, None]
    return I, J


def _linked(I, J, Kinv_y, Kinv, scale, nugget):
    mu = (I * Kinv_y).sum(-1)
    quad = (Kinv_y[..., :, None] * J * Kinv_y[..., None, :]).sum((-1, -2))
    tr = (Kinv * J).sum((-1, -2))
    return mu, torch.abs(quad - mu ** 2 + scale * (1.0 + nugget - tr))


def link_vecch(m, v, z, W, Zg, NN, y, scale, length, nugget):
    """Linked-GP mean and variance of a Vecchia sexp node under Gaussian
    inputs (m, v) (M, Dw), with the deterministic global input z (M, Dz)
    (training values Zg (n, Dz)) or None, over each query's neighbours NN
    (M, k) among the training inputs W (n, Dw)."""
    Dw = W.shape[1]
    full = torch.broadcast_to(length, (Dw + (0 if z is None else z.shape[1]),))
    valid = NN >= 0
    idx = torch.where(valid, NN, 0)
    Wc = W[idx]
    I, J = _moments(Wc, m, v, full[:Dw])
    Xc = Wc
    if z is not None:
        Gc = Zg[idx]
        Iz = corr(Gc, z[:, None, :], full[Dw:], "sexp")[..., 0]
        I = I * Iz
        J = J * Iz[..., :, None] * Iz[..., None, :]
        Xc = torch.cat([Wc, Gc], dim=-1)
    both = valid[..., :, None] & valid[..., None, :]
    I = torch.where(valid, I, 0.0)
    J = torch.where(both, J, 0.0)
    diag = torch.full(valid.shape, 1.0 + nugget, dtype=W.dtype, device=W.device)
    L = torch.linalg.cholesky(_masked(corr(Xc, Xc, full, "sexp"), valid, diag))
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    Kinv = torch.cholesky_solve(eye, L)
    Kinv_y = torch.cholesky_solve(torch.where(valid, y[idx], 0.0)[..., None], L)[..., 0]
    return _linked(I, J, Kinv_y, Kinv, scale, nugget)


def link_dense(m, v, W, y, scale, length, nugget, chunk=16):
    """Linked-GP mean and variance of a dense sexp node under Gaussian
    inputs (m, v) (M, D) with training inputs W (n, D)."""
    n = W.shape[0]
    full = torch.broadcast_to(length, (W.shape[1],))
    K = corr(W, W, full, "sexp") + nugget * torch.eye(n, dtype=W.dtype, device=W.device)
    L = torch.linalg.cholesky(K)
    Kinv = torch.cholesky_inverse(L)
    Kinv_y = torch.cholesky_solve(y[:, None], L)[:, 0]
    mus, vs = [], []
    for s in range(0, m.shape[0], chunk):
        I, J = _moments(W, m[s:s + chunk], v[s:s + chunk], full)
        a, b = _linked(I, J, Kinv_y, Kinv, scale, nugget)
        mus.append(a)
        vs.append(b)
    return torch.cat(mus), torch.cat(vs)


def gap(mu, var, mu_ref, var_ref):
    """The widest gap of predictions from the reference's: over the points,
    the larger of |mean - ref mean| / ref sd and |var - ref var| / ref var."""
    return float(torch.maximum((mu - mu_ref).abs() / var_ref.sqrt(),
                               (var - var_ref).abs() / var_ref).max())


def mixture(means, variances):
    """Moments of the equal-weight mixture of the imputations' Gaussians:
    means and variances (N, M)."""
    mu = means.mean(0)
    return mu, (means ** 2 + variances).mean(0) - mu ** 2
