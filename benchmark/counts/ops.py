"""Operations and bytes of one call of each counted entry point, from its
arguments' shapes alone: the benchmark's frozen yardstick for rooflines and
whole-step shares of the card's peak.

The kernels' counts (K1-K4) are those of the sexp pipeline per Vecchia
block as `chip_smoke._bound_ms` states them at the time this benchmark was
written (an exponential or a square root counts as one): the correlation
pairs, the column Cholesky, the substitutions, and for K1 the gradient by
whichever of its two algorithms needs fewer operations; K2 counts the TPU
kernel's algorithm (the static dims' correlation once a point where
0 < dl < d).  Bytes count each input element read once and each output
element written once.  Nothing here depends on how a kernel is designed.

The predictions' counts follow the formulas the port computes in plain
PyTorch (`vecchia.core.gp_vecch`, `link_gp_vecch`, `gp_core.linkgp_predict`):
per query the block's correlations, its factorisation and solves, and the
linked moments I (one exponential and about five operations per neighbour
and dimension) and J (about eight per pair and dimension), the trace and
the quadratic forms.

Each function takes the call's positional and keyword arguments and returns
(operations, bytes).
"""


def _numel(t):
    n = 1
    for s in t.shape:
        n *= s
    return n


def _size(t):
    return t.element_size()


def _chol(m1):
    return sum(2 * j + 1 + (m1 - 1 - j) * (2 * j + 2) for j in range(m1))


def _pairs(m1):
    return m1 * (m1 - 1) // 2


def k3(args, kw):
    """cond_weights_t(Xg (m1, d, n), diag (m1, n))."""
    Xg = args[0]
    m1, d, n = Xg.shape[-3], Xg.shape[-2], Xg.shape[-1]
    per = _pairs(m1) * (3 * d + 1) + _chol(m1) + (m1 - 1) ** 2
    elems = sum(_numel(t) for t in args[:2]) + m1 * n
    return n * per, elems * _size(Xg)


def k2(args, kw):
    """block_loglik_multi_t(A, B, C (m1, d, n), yg, diag (m1, n), cosv, sinv
    (K,), dl=)."""
    A = args[0]
    m1, d, n = A.shape[-3], A.shape[-2], A.shape[-1]
    K = args[5].shape[0]
    dl = kw.get("dl")
    dl = d if dl is None or dl == 0 or dl >= d else dl
    pairs = _pairs(m1)
    lat = 4 * m1 * dl + pairs * (3 * dl + 1)
    once = 0
    if dl < d:
        once = pairs * (3 * (d - dl) + 1)
        lat += pairs
    ops = K * n * (lat + _chol(m1) + m1 * m1) + n * once
    elems = sum(_numel(t) for t in args[:7]) + 2 * K * n
    return ops, elems * _size(A)


def k4(args, kw):
    """block_loglik_parts_t(Xg (..., m1, d, n), yg, diag)."""
    Xg = args[0]
    m1, d = Xg.shape[-3], Xg.shape[-2]
    blocks = _numel(Xg) // (m1 * d)
    per = _pairs(m1) * (3 * d + 1) + _chol(m1) + m1 * m1
    elems = sum(_numel(t) for t in args[:3]) + 2 * blocks
    return blocks * per, elems * _size(Xg)


def k1(args, kw):
    """block_nllik_grad_parts_t(Xg ([G,] m1, d, n), yg, diag, dnug,
    n_length=, nugget_est=)."""
    Xg = args[0]
    m1, d, n = Xg.shape[-3], Xg.shape[-2], Xg.shape[-1]
    G = Xg.shape[0] if Xg.dim() == 4 else 1
    nlen = kw["n_length"]
    nug = int(kw["nugget_est"])
    p = nlen + nug
    pairs = _pairs(m1)
    solve = m1 * m1
    forward = pairs * nlen * 6 + m1 + p * (solve + 2 * m1 + 4)
    pair_forms = solve + pairs * (6 * nlen + 6) + 2 * m1 + 4 * m1 * nug + 4 * p
    per = pairs * (3 * d + 1) + _chol(m1) + 2 * solve + min(forward, pair_forms)
    elems = sum(_numel(t) for t in args[:4]) + 2 * G * n + 2 * G * p * n
    return G * n * per, elems * _size(Xg)


def gp_vecch(args, kw):
    """vecchia.core.gp_vecch(x (M, d), w_train, NNarray (M, k), y, ...):
    per query a block of k + 1, its factor, one solve and a dot."""
    x, NN = args[0], args[2]
    M, d = x.shape
    m1 = NN.shape[1] + 1
    per = _pairs(m1) * (3 * d + 1) + _chol(m1) + m1 * m1 + 2 * m1
    elems = _numel(x) + M * m1 * (d + 1) + _numel(NN) + 2 * M
    return M * per, elems * _size(x)


def link_gp_vecch(args, kw):
    """vecchia.core.link_gp_vecch(m, v (M, Dw), z (M, Dz) or None, w1,
    global_w1, NNarray (M, k), ...): per query I and J over its k
    neighbours, the block's factor, two triangular solves of J, the trace
    and the quadratic forms."""
    m, z, NN = args[0], args[2], args[5]
    M, Dw = m.shape
    D = Dw + (0 if z is None else z.shape[1])
    k = NN.shape[1]
    per = (k * (5 * D + 2) + k * k * (8 * D + 2) + _pairs(k) * (3 * D + 1) + _chol(k)
           + 2 * k ** 3 + 4 * k * k + 4 * k)
    elems = 2 * _numel(m) + (0 if z is None else _numel(z)) + M * k * (D + 1) + 2 * M
    return M * per, elems * _size(m)


def linkgp_dense(args, kw):
    """gp_core.linkgp_predict(m, v (M, Dw), z, X (n, Dw), Zglobal, Rinv (n,
    n), Rinv_y (n,), ...): per query I over n points, J over n^2 pairs, the
    trace against Rinv and the quadratic form."""
    m, z, X = args[0], args[2], args[3]
    M, Dw = m.shape
    D = Dw + (0 if z is None else z.shape[1])
    n = X.shape[0]
    per = n * (5 * D + 2) + n * n * (8 * D + 2) + 4 * n * n + 4 * n
    elems = 2 * _numel(m) + _numel(X) + n * n + n + 2 * M
    return M * per, elems * _size(m)


def least_seconds(ops, nbytes, peaks):
    """The least time the card could take: the larger of operations over
    the float64 tensor-core rate and bytes over the memory rate."""
    return max(ops / peaks["fp64_tensor_flops"], nbytes / peaks["hbm_bytes_s"])
