"""Nearest-neighbour search for the Vecchia approximation; the counterpart
of `dgp_tpu/vecchia/nn.py`.

Exact search is a tiled top-k over full distance rows.  Approximate search
(``method='approx'``, with the aliases 'hnsw' and 'ivf') is the JAX
package's IVF scheme: a k-means coarse quantizer, inverted bucket lists,
and an exact top-k restricted to the candidates of the ``P`` buckets whose
centroids lie nearest.  It engages once n > 4 * _BLOCK points.

Layout conventions match the JAX package:
  * `nn(x, m)`: for points already in Vecchia order, row i holds the indices
    {i and its m nearest predecessors} sorted in DESCENDING index order,
    padded with -1 (so reversing a row gives ascending order with the point
    itself last).
  * `get_pred_nn(query, x, m)`: unconstrained m nearest training points per
    query, nearest first.

Distances to centroids and in the exact search use the Gram form of the
JAX package; the IVF candidates' distances use its difference form (the
Gram form loses the low bits of the small distances that rank the nearest
neighbours), in segments of `_SEG` candidates.  So in float64 the two
packages pick the same neighbour sets.  The k-means centroid sums go
through `torch.segment_reduce`, which sums each cluster's members one after
another in index order, as the JAX package's segment sum does on the CPU,
and without atomics, so a build gives the same arrays on every run.

An IVF index's k-means and lists are an ``nn.ivf_build`` span, a search
through it an ``nn.ivf_query`` span (`tracing`); the reads to the host are
`tracing` reads.
"""
import numpy as np
import torch

from .. import config, tracing

#: query rows per distance tile
_BLOCK = 256
#: the names of the approximate search
APPROX_METHODS = ('approx', 'hnsw', 'ivf')
#: buckets searched per query (the JAX package's P)
N_PROBE = 16
#: candidates per distance segment of the IVF search
_SEG = 4096
#: k-means iterations from the deterministic start, and from warm centroids
KMEANS_ITERS, KMEANS_WARM_ITERS = 6, 2
#: bytes of one batch's difference tiles in the IVF search
TILE_BYTES = 1 << 30
#: query-list capacity multiple of the average bucket size (queries beyond
#: a bucket's capacity go through the per-query fallback pass)
_LQ_MULT = 2.5


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


def is_approx(method, n):
    """Whether ``method`` searches n points with the IVF index."""
    return method in APPROX_METHODS and n > 4 * _BLOCK


def nn(x, m, method='exact', cache=None, device=None):
    """Ordered nearest neighbours of the (already ordered) points x, as a
    numpy int array (reference vecchia.nn); the search runs on ``device``
    (default: the card, see config.resolve_device).  ``cache`` (a dict kept
    by the caller across refreshes) warm-starts the IVF k-means from the
    centroids of the last build."""
    x = np.asarray(x)
    m = min(int(m), x.shape[0] - 1)
    xt = torch.as_tensor(x, device=config.resolve_device(device))
    if is_approx(method, x.shape[0]):
        return tracing.to_host(nn_approx(xt, m, cache=cache)[0], 'nn_result').numpy()
    return tracing.to_host(_nn_ordered_impl(xt, m), 'nn_result').numpy()


def get_pred_nn(query, x, m=50, method='exact', device=None):
    """Unconstrained NN of each query among x, nearest first, as a numpy
    int array (reference vecchia.get_pred_nn); the search runs on
    ``device`` (default: the card)."""
    query, x = np.asarray(query), np.asarray(x)
    m = int(min(m, x.shape[0]))
    dev = config.resolve_device(device)
    qt, xt = torch.as_tensor(query, device=dev), torch.as_tensor(x, device=dev)
    if is_approx(method, x.shape[0]):
        return tracing.to_host(_pred_nn_approx(qt, xt, m), 'nn_result').numpy()
    return tracing.to_host(_pred_nn_impl(qt, xt, m), 'nn_result').numpy()


# ----------------------------------------------------------------------
# approximate (IVF) search
# ----------------------------------------------------------------------
def _ivf_params(n):
    """(K, Lmax) of an n-point index: K = ceil(2 sqrt(n)) buckets whose
    candidate lists hold at most twice the average bucket size (the
    members beyond it are dropped from the candidates, as the reference's
    HNSW ef bound drops them)."""
    K = int(np.ceil(2.0 * np.sqrt(n)))
    Lmax = int(np.ceil(2.0 * n / K))
    return K, Lmax


def _lq(n, K):
    """Query-list capacity of a bucket in the self-query."""
    return int(np.ceil(_LQ_MULT * n / K))


def _fallback_cap(n):
    """Most rows the per-query fallback pass takes (bucket-overflow queries
    beyond it keep only themselves)."""
    r = max(_BLOCK, n // 64)
    return ((r + _BLOCK - 1) // _BLOCK) * _BLOCK


def _assign(x, cent):
    """Nearest centroid of each row (Gram-form distances, first on ties)."""
    rows = max(_BLOCK, (1 << 24) // max(cent.shape[0], 1))
    return torch.cat([torch.argmin(_sq_dists_block(x[s:s + rows], cent), dim=1)
                      for s in range(0, x.shape[0], rows)])


def _kmeans_fit(x, K, iters, cent0=None):
    """Lloyd k-means: (centroids (K, d), assignments (n,)).  The start is
    the rows (i * (n // K)) % n, or ``cent0``; an empty cluster keeps its
    centroid.  Each cluster's sum runs over its members in index order."""
    n = x.shape[0]
    ks = torch.arange(K, device=x.device)
    if cent0 is None:
        cent = x[(ks * (n // K)) % n]
    else:
        cent = torch.as_tensor(np.asarray(cent0), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        a = _assign(x, cent)
        order = torch.argsort(a, stable=True)
        a_sorted = a[order]
        cnts = (torch.searchsorted(a_sorted, ks, right=True)
                - torch.searchsorted(a_sorted, ks))
        # unsafe: the lengths sum to n by construction, and checking it
        # would read them back to the host
        sums = torch.segment_reduce(x[order], 'sum', lengths=cnts, axis=0, unsafe=True)
        cnts = cnts.to(x.dtype)[:, None]
        cent = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0), cent)
    return cent, _assign(x, cent)


def _buckets(assign, K, L):
    """(K, L) inverted lists of the assignments, each in index order and
    -1 padded; members beyond a list's capacity L are left out."""
    n = assign.shape[0]
    dev = assign.device
    order = torch.argsort(assign, stable=True)
    a_sorted = assign[order]
    start = torch.searchsorted(a_sorted, torch.arange(K, device=dev))
    pos = torch.arange(n, device=dev) - start[a_sorted]
    out = torch.full((K, L + 1), -1, dtype=torch.int64, device=dev)
    out[a_sorted, torch.clamp(pos, max=L)] = order   # overflow parks in column L
    return out[:, :L]


def _fit(x, cache=None):
    """The k-means of an index over x: from the centroids in ``cache``
    (two refinement passes) when they fit, else cold; the cache then holds
    the new centroids (numpy, so that a model pickles without tensors)."""
    K, _ = _ivf_params(x.shape[0])
    cent0 = None if cache is None else cache.get('cent')
    if cent0 is not None and cent0.shape == (K, x.shape[1]):
        cent, assign = _kmeans_fit(x, K, KMEANS_WARM_ITERS, cent0)
    else:
        cent, assign = _kmeans_fit(x, K, KMEANS_ITERS)
    if cache is not None:
        cache['cent'] = tracing.to_host(cent, 'nn_cache').numpy()
    return cent, assign


def _topk_segments(Q, X, cand, masks, k, big):
    """Top-k nearest candidates by squared distance (difference form) under
    one or more validity masks, in segments of `_SEG` candidates: a local
    top-k per segment, then a top-k over the segments' winners.  Q (..., r,
    d) queries, X (..., C, d) or (..., r, C, d) candidate points, cand (...,
    C) or (..., r, C) their indices, masks (..., r, C).  Returns per mask
    (neg_dist, idx), each (..., r, <= k)."""
    C = masks[0].shape[-1]
    shared = cand.dim() < masks[0].dim()
    parts = [([], []) for _ in masks]
    for s0 in range(0, C, _SEG):
        Xs = X[..., s0:s0 + _SEG, :]
        cs = cand[..., s0:s0 + _SEG]
        if shared:
            d2 = torch.sum((Q[..., :, None, :] - Xs[..., None, :, :]) ** 2, dim=-1)
            cs = cs[..., None, :].expand(d2.shape)
        else:
            d2 = torch.sum((Q[..., :, None, :] - Xs) ** 2, dim=-1)
        for j, mk in enumerate(masks):
            nd, sel = torch.topk(torch.where(mk[..., s0:s0 + _SEG], -d2, -big),
                                 min(k, d2.shape[-1]), dim=-1)
            parts[j][0].append(nd)
            parts[j][1].append(torch.gather(cs, -1, sel))
    return [(torch.cat(nd, dim=-1), torch.cat(ci, dim=-1)) for nd, ci in parts]


def _merge(nd, ci, k, big):
    """Top-k of concatenated segment winners; -1 where no candidate was
    valid."""
    nd2, sel = torch.topk(nd, min(k, nd.shape[-1]), dim=-1)
    idx = torch.gather(ci, -1, sel)
    return torch.where(-nd2 < big / 2, idx, -1)


def _row_batch(C, d, itemsize, per_row=1):
    """Rows (each a bucket of ``per_row`` queries, or one query) per batch
    whose gathered candidates, difference tiles and masks fit
    `TILE_BYTES`."""
    per = (C * (d + 1) + per_row * min(C, _SEG) * (d + 3)) * itemsize + 3 * per_row * C
    return max(1, TILE_BYTES // per)


def _bucketed_self(x, Bq, cl, Bc, m, impute, batch=None):
    """Bucket-batched ordered self-query: the members of each bucket (rows
    of ``Bq``) share one candidate set, the lists (rows of ``Bc``) of the
    bucket's nearest buckets (rows of ``cl``).  Each point also takes itself
    at distance 0.  ``batch`` buckets run at a time (default: as many as
    `TILE_BYTES` holds); no result depends on it.  Returns the per-bucket
    ordered top-(m+1) (K, Lq, m+1), and with ``impute`` the unconstrained
    one."""
    K, Lq = Bq.shape
    C = cl.shape[1] * Bc.shape[1]
    big = torch.finfo(x.dtype).max / 8
    if batch is None:
        batch = _row_batch(C, x.shape[1], x.element_size(), Lq)
    outs = ([], [])
    for k0 in range(0, K, batch):
        qrows = Bq[k0:k0 + batch]                          # (b, Lq)
        cnd = Bc[cl[k0:k0 + batch]].reshape(qrows.shape[0], C)
        ok_c = cnd >= 0
        Xc = x[torch.where(ok_c, cnd, 0)]                   # (b, C, d)
        row_ok = qrows >= 0
        gq = torch.where(row_ok, qrows, 0)
        Q = x[gq]                                           # (b, Lq, d)
        # the query's own bucket copy goes; it comes back as the appended
        # zero-distance column
        base = (ok_c[:, None, :] & (cnd[:, None, :] != gq[:, :, None])
                & row_ok[:, :, None])
        masks = [base & (cnd[:, None, :] <= gq[:, :, None])]
        if impute:
            masks.append(base)
        self_nd = torch.where(row_ok, x.new_zeros(()), x.new_full((), -big))[..., None]
        for j, (nd, ci) in enumerate(_topk_segments(Q, Xc, cnd, masks, m + 1, big)):
            outs[j].append(_merge(torch.cat([nd, self_nd], dim=-1),
                                  torch.cat([ci, gq[..., None]], dim=-1), m + 1, big))
    return torch.cat(outs[0]), (torch.cat(outs[1]) if impute else None)


def _query_rows(rows, x, cent, Bc, m, impute):
    """Per-query ordered IVF search of the rows ``rows`` of x (the
    fallback pass for rows beyond their bucket's query capacity): the
    candidates of the `N_PROBE` buckets nearest each row, and the row
    itself.  Row indices are the Vecchia positions that the
    predecessors-only mask compares."""
    big = torch.finfo(x.dtype).max / 8
    C = N_PROBE * Bc.shape[1] + 1
    step = _row_batch(C, x.shape[1], x.element_size())
    outs = ([], [])
    for s in range(0, rows.shape[0], step):
        gq = rows[s:s + step]
        Q = x[gq]
        cl = torch.topk(-_sq_dists_block(Q, cent), N_PROBE, dim=1).indices
        cand = torch.cat([Bc[cl].reshape(gq.shape[0], -1), gq[:, None]], dim=1)
        ok = cand >= 0
        dup = cand == gq[:, None]
        dup[:, -1] = False
        base = ok & ~dup
        masks = [base & (cand <= gq[:, None])]
        if impute:
            masks.append(base)
        safe = torch.where(ok, cand, 0)
        for j, (nd, ci) in enumerate(_topk_segments(Q, x[safe], safe, masks, m + 1, big)):
            outs[j].append(_merge(nd, ci, m + 1, big))
    return torch.cat(outs[0]), (torch.cat(outs[1]) if impute else None)


def _scatter_rows(out, qflat, rows):
    """out (n+1, w) with ``rows`` written at positions qflat (-1: the
    parked last row)."""
    out[torch.where(qflat >= 0, qflat, out.shape[0] - 1)] = rows
    return out


def nn_approx(x, m, impute=False, cache=None, batch=None):
    """Ordered approximate NN of the (already ordered) points x (a tensor):
    the k-means (warm from ``cache``), the inverted lists, the
    bucket-batched self-query (``batch`` buckets at a time), the fallback
    pass for rows beyond their bucket's query capacity (one host read), and
    for a row no pass covered, itself alone.  Returns the reference layout
    (n, m+1) (descending index order, -1 padded) and, with ``impute``, the
    unconstrained m-1 nearest other points of each row, nearest first, 0
    padded (n, m-1)."""
    m = int(m)
    n = x.shape[0]
    K, Lc = _ivf_params(n)
    with tracing.span('nn.ivf_build'):
        cent, assign = _fit(x, cache)
        Bq = _buckets(assign, K, _lq(n, K))
    Bc = Bq[:, :Lc]
    with tracing.span('nn.ivf_query'):
        cl = torch.topk(-_sq_dists_block(cent, cent), N_PROBE, dim=1).indices
        o_b, u_b = _bucketed_self(x, Bq, cl, Bc, m, impute, batch)
        qflat = Bq.reshape(-1)
        empty = torch.full((n + 1, m + 1), -1, dtype=torch.int64, device=x.device)
        out = _scatter_rows(empty.clone(), qflat, o_b.reshape(-1, m + 1))
        imp = _scatter_rows(empty.clone(), qflat, u_b.reshape(-1, m + 1)) if impute else None
        cov = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
        cov[torch.where(qflat >= 0, qflat, n)] = True
        with tracing.host_read('nn_fallback'):
            rows = torch.nonzero(~cov[:n]).reshape(-1)[:_fallback_cap(n)]
        if rows.numel():
            fo, fu = _query_rows(rows, x, cent, Bc, m, impute)
            out[rows] = fo
            if impute:
                imp[rows] = fu
    out = out[:n]
    # a row that no pass covered keeps itself, so no conditioning set is
    # empty
    stranded = (out < 0).all(dim=1)
    out[:, 0] = torch.where(stranded, torch.arange(n, device=x.device), out[:, 0])
    ordered = torch.flip(torch.sort(out, dim=1).values, dims=(1,))
    if not impute:
        return ordered, None
    imp = imp[:n]
    return ordered, torch.where(imp >= 0, imp, 0)[:, 1:m]


def _ivf_build(x):
    """A prediction index over x (a tensor): centroids and (K, Lmax)
    inverted lists from a cold k-means."""
    K, Lmax = _ivf_params(x.shape[0])
    with tracing.span('nn.ivf_build'):
        cent, assign = _kmeans_fit(x, K, KMEANS_ITERS)
        return cent, _buckets(assign, K, Lmax)


def _ivf_query(q, x, cent, buckets, m):
    """Unordered cluster-restricted top-m: for each query row, the m
    nearest candidates of the `N_PROBE` buckets whose centroids lie
    nearest, nearest first; -1 where fewer than m candidates exist."""
    with tracing.span('nn.ivf_query'):
        big = torch.finfo(x.dtype).max / 8
        step = _row_batch(N_PROBE * buckets.shape[1], x.shape[1], x.element_size())
        outs = []
        for s in range(0, q.shape[0], step):
            Q = q[s:s + step]
            cl = torch.topk(-_sq_dists_block(Q, cent), N_PROBE, dim=1).indices
            cand = buckets[cl].reshape(Q.shape[0], -1)
            ok = cand >= 0
            safe = torch.where(ok, cand, 0)
            (nd, ci), = _topk_segments(Q, x[safe], safe, [ok], m, big)
            outs.append(_merge(nd, ci, m, big))
        return torch.cat(outs)


def _pred_nn_approx(query, x, m):
    """get_pred_nn through a fresh IVF index over x."""
    return pred_nn_t(query, x, m, _ivf_build(x))


def pred_nn_t(query, x, m, index=None):
    """The m nearest rows of x to each query row, nearest first (m at most
    x's rows), on the tensors' device: the exact search, or with the IVF
    ``index`` of x (`_ivf_build`) the approximate one, any -1 (too few
    candidates) set to 0."""
    if index is None:
        return _pred_nn_impl(query, x, m)
    out = _ivf_query(query, x, index[0], index[1], m)
    return torch.where(out >= 0, out, 0)
