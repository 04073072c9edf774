"""Plain Vecchia Gaussian-process arithmetic in PyTorch: the benchmark's
reference for what the port computes on its timed paths.

It imports torch alone: nothing of the port and nothing of the JAX package.
Conventions are dgpsi's (the model family's published code):

  * ``sexp``: k(x, y) = exp(-sum_d ((x_d - y_d) / l_d)^2);
  * ``matern2.5``: prod_d (1 + sqrt5 a_d + 5/3 a_d^2) exp(-sqrt5 sum_d a_d),
    a_d = |x_d - y_d| / l_d;
  * a training block's diagonal is 1 + nugget.

A Vecchia neighbour row is ``[i, j_1, j_2, ...]`` (the point first, -1 for
missing neighbours) in the index space of the ordered points; point i is
conditioned on its neighbours.  Everything here is computed from those rows
and the points' coordinates and targets: blocks are built, factored with
`torch.linalg.cholesky` and solved in chunks of rows, so that n = 1e5 fits.
"""
import math

import torch

SQRT5 = math.sqrt(5.0)
#: rows of blocks per chunk: (m+1)^2 doubles a row, with its temporaries
CHUNK = 16384


def corr(X, Z, length, name):
    """(..., n, m) correlations between (..., n, d) X and (..., m, d) Z."""
    diff = (X / length)[..., :, None, :] - (Z / length)[..., None, :, :]
    if name == "sexp":
        return torch.exp(-(diff * diff).sum(-1))
    if name == "matern2.5":
        a = diff.abs()
        return (torch.prod(1.0 + SQRT5 * a + (5.0 / 3.0) * a * a, dim=-1)
                * torch.exp(-SQRT5 * a.sum(-1)))
    raise ValueError(f"unknown kernel: {name}")


def ordered_nn(Xo, m, rows=None, chunk=256):
    """Each row's exact neighbour row among the points before it in the
    ordering of ``Xo`` (already length-scaled): [i, its m nearest
    predecessors nearest first, -1 where it has fewer].  ``rows``: only
    these rows (all by default)."""
    n = Xo.shape[0]
    rows = torch.arange(n, device=Xo.device) if rows is None else rows
    out = []
    for s in range(0, rows.numel(), chunk):
        r = rows[s:s + chunk]
        d = ((Xo[r][:, None, :] - Xo[None, :, :]) ** 2).sum(-1)
        d = torch.where(torch.arange(n, device=Xo.device)[None, :] < r[:, None], d, torch.inf)
        dist, idx = torch.topk(d, min(m, n), dim=1, largest=False)
        out.append(torch.cat([r[:, None], torch.where(torch.isfinite(dist), idx, -1)], 1))
    return torch.cat(out)


def _rows(n, chunk=CHUNK):
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def _masked(K, valid, diag):
    """K with invalid lanes decoupled to the identity and ``diag`` on the
    valid lanes' diagonal."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    both = valid[..., :, None] & valid[..., None, :]
    K = torch.where(both, K, eye) * (1.0 - eye)
    return K + torch.diag_embed(torch.where(valid, diag, torch.ones_like(diag)))


def blocks(X, y, NN, length, nugget, name):
    """Blocks of the rows NN (b, m+1): the neighbours in ascending order, the
    point last.  Returns (K (b, m+1, m+1), y (b, m+1), valid (b, m+1))."""
    rev = torch.flip(NN, dims=(1,))
    valid = rev >= 0
    idx = torch.where(valid, rev, 0)
    Xi = X[idx]
    diag = (1.0 + nugget) * torch.ones(valid.shape, dtype=X.dtype, device=X.device)
    K = _masked(corr(Xi, Xi, length, name), valid, diag)
    yi = torch.where(valid, y[idx], 0.0) if y is not None else None
    return K, yi, valid


def point_parts(X, y, NN, length, nugget, name):
    """Per-point (log conditional variance, squared standardised residual)
    of the rows NN: (logdet_i (b,), quad_i (b,))."""
    K, yi, _ = blocks(X, y, NN, length, nugget, name)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, yi[..., None], upper=False)[..., -1, 0]
    return 2.0 * torch.log(L[:, -1, -1]), z * z


def loglik(X, y, NN, scale, length, nugget, name, chunk=CHUNK):
    """Vecchia log-likelihood without its constant: -0.5 sum_i (log v_i +
    r_i^2 / (scale v_i)), as the ESS target of a layer's latent draws."""
    ld = q = 0.0
    with torch.no_grad():
        for r in _rows(X.shape[0], chunk):
            a, b = point_parts(X, y, NN[r], length, nugget, name)
            ld = ld + a.sum()
            q = q + b.sum()
    return -0.5 * (ld + q / scale)


def cond_weights(X, NN, length, nugget, name, chunk=CHUNK):
    """Conditional weights of each point on its neighbours in ascending
    order, and its conditional standard deviation (unit scale): w (n, m)
    with zeros on missing lanes, sigma (n,)."""
    ws, sig = [], []
    with torch.no_grad():
        for r in _rows(X.shape[0], chunk):
            K, _, valid = blocks(X, None, NN[r], length, nugget, name)
            Kcc, kci = K[:, :-1, :-1], K[:, :-1, -1:]
            Lc = torch.linalg.cholesky(Kcc)
            w = torch.cholesky_solve(kci, Lc)[..., 0]
            w = torch.where(valid[:, :-1], w, 0.0)
            v = K[:, -1, -1] - (w * kci[..., 0]).sum(-1)
            ws.append(w)
            sig.append(torch.sqrt(v))
    return torch.cat(ws), torch.cat(sig)


class NodeObjective:
    """The M-step objective of one GP node, as dgpsi states it: the profiled
    (``scale_est``) or fixed-scale Vecchia negative log-likelihood minus the
    gamma log-prior on the log-parameters, over lt = (log lengths, log
    nugget if ``nugget_est``).  Calls return (value, gradient, scale), the
    gradient by autograd through the library Cholesky, chunk by chunk."""

    def __init__(self, X, y, NN, name, *, n_length, nugget_est, nugget, scale_est, scale,
                 prior_coef, chunk=CHUNK):
        self.X, self.y, self.NN, self.name = X, y, NN, name
        self.n_length, self.nugget_est = n_length, nugget_est
        self.nugget, self.scale_est, self.scale = nugget, scale_est, scale
        self.prior_coef = prior_coef
        self.chunk = chunk

    def params(self, lt):
        length = torch.exp(lt[:self.n_length])
        nugget = torch.exp(lt[self.n_length]) if self.nugget_est else self.nugget
        return length, nugget

    def sums(self, lt):
        """(sum log v_i, sum quad_i) and their gradients with respect to lt."""
        L = Q = 0.0
        dL = torch.zeros_like(lt)
        dQ = torch.zeros_like(lt)
        for r in _rows(self.X.shape[0], self.chunk):
            with torch.enable_grad():
                lt_ = lt.detach().requires_grad_(True)
                length, nugget = self.params(lt_)
                a, b = point_parts(self.X, self.y, self.NN[r], length, nugget, self.name)
                a, b = a.sum(), b.sum()
                ga, = torch.autograd.grad(a, lt_, retain_graph=True)
                gb, = torch.autograd.grad(b, lt_)
            L, Q = L + a.detach(), Q + b.detach()
            dL, dQ = dL + ga, dQ + gb
        return L, Q, dL, dQ

    def __call__(self, lt):
        n = self.X.shape[0]
        L, Q, dL, dQ = self.sums(lt)
        if self.scale_est:
            scale = Q / n
            nll = 0.5 * (L + n * torch.log(scale))
            g = 0.5 * (dL + n * dQ / Q)
        else:
            scale = torch.as_tensor(self.scale, dtype=lt.dtype, device=lt.device)
            nll = 0.5 * (L + Q / scale)
            g = 0.5 * (dL + dQ / scale)
        if self.prior_coef is not None:
            c0, c1 = self.prior_coef
            e = torch.exp(lt)
            nll = nll - (c0 * lt - c1 * e).sum()
            g = g - (c0 - c1 * e)
        return nll, g, scale
