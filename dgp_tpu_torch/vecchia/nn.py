"""Exact nearest-neighbour search for the Vecchia approximation; the
counterpart of the exact path of `dgp_tpu/vecchia/nn.py`.

Layout conventions match the JAX package:
  * `nn(x, m)`: for points already in Vecchia order, row i holds the indices
    {i and its m nearest predecessors} sorted in DESCENDING index order,
    padded with -1 (so reversing a row gives ascending order with the point
    itself last).
  * `get_pred_nn(query, x, m)`: unconstrained m nearest training points per
    query, nearest first.

Distances use the same Gram form as the JAX package's exact search, so in
float64 the two packages pick the same neighbour sets.  The approximate
(IVF) search and the native host search for very large n are not ported.
"""
import numpy as np
import torch

from .. import config

#: query rows per distance tile
_BLOCK = 256


def _sq_dists_block(Q, X):
    qq = torch.sum(Q * Q, dim=1)[:, None]
    xx = torch.sum(X * X, dim=1)[None, :]
    return torch.clamp(qq + xx - 2.0 * Q @ X.T, min=0.0)


def _rows_per_tile(n):
    # keep one (rows, n) distance tile near 32 MB of float64
    return max(_BLOCK, (1 << 22) // max(n, 1) // _BLOCK * _BLOCK)


def _nn_ordered_impl(x, m):
    """(n, m+1) ordered NN of the rows of x (a tensor), see module doc."""
    n = x.shape[0]
    big = torch.finfo(x.dtype).max / 8
    idx_all = torch.arange(n, device=x.device)
    rows = _rows_per_tile(n)
    outs = []
    for s in range(0, n, rows):
        Q = x[s:s + rows]
        q_idx = s + torch.arange(Q.shape[0], device=x.device)
        d2 = _sq_dists_block(Q, x)
        d2 = torch.where(idx_all[None, :] > q_idx[:, None],
                         torch.full_like(d2, big), d2)
        neg_d, nn_idx = torch.topk(-d2, m + 1, dim=1)
        valid = -neg_d < big / 2
        outs.append(torch.where(valid, nn_idx, -1))
    out = torch.cat(outs, dim=0)
    return torch.flip(torch.sort(out, dim=1).values, dims=(1,))


def _pred_nn_impl(query, x, m):
    """(nq, m) nearest rows of x for each query row, nearest first."""
    rows = _rows_per_tile(x.shape[0])
    outs = []
    for s in range(0, query.shape[0], rows):
        d2 = _sq_dists_block(query[s:s + rows], x)
        outs.append(torch.topk(-d2, m, dim=1).indices)
    return torch.cat(outs, dim=0)


def nn(x, m, device=None):
    """Ordered nearest neighbours of the (already ordered) points x, as a
    numpy int array (reference vecchia.nn); the search runs on ``device``
    (default: the card, see config.resolve_device)."""
    x = np.asarray(x)
    m = min(int(m), x.shape[0] - 1)
    xt = torch.as_tensor(x, device=config.resolve_device(device))
    return _nn_ordered_impl(xt, m).cpu().numpy()


def get_pred_nn(query, x, m=50, device=None):
    """Unconstrained NN of each query among x, nearest first, as a numpy
    int array (reference vecchia.get_pred_nn); the search runs on
    ``device`` (default: the card)."""
    query, x = np.asarray(query), np.asarray(x)
    m = int(min(m, x.shape[0]))
    dev = config.resolve_device(device)
    out = _pred_nn_impl(torch.as_tensor(query, device=dev),
                        torch.as_tensor(x, device=dev), m)
    return out.cpu().numpy()
