"""K5 `linked_dense_t`: the dense linked-GP moments as one hand-written
Hopper kernel, with its plain PyTorch version.

For M Gaussian queries (means m, variances v, each (M, D)) against the
training inputs X (n, D) of a dense GP node, with optional row weights W
(M, n) (the deterministic global input's correlations) and a = Rinv_y,
both return, each (M,):

    mu   = (I * W) @ a
    tr   = sum_ij Rinv_ij (J * W_i W_j)_ij
    quad = a^T (J * W_i W_j) a

with I, J the closed-form moments of `moments.IJ`.  The plain version
(`linked_dense_t_plain`) materialises each query's (n, n) J; the kernel
(`csrc/linked_dense.cu`) never stores it: one thread block per 64 x 64
tile of the pairs' upper triangle loops over the call's queries with J in
registers, and a second pass adds each query's tile sums in a fixed
order, so a query's values depend neither on M nor on the other queries.
dgp_tpu has no kernel here (it computes the moments in plain JAX), so K5
replaces none.

As K1-K4 (`cuda_vecchia`): a CPU tensor takes the plain version, a CUDA
tensor the kernel (counted in ``kernel.launches.K5`` and
``kernel.launches.K5@<device>``), and a kernel that fails to build or to
launch raises; nothing falls back.  The kernel is built with K1-K4 into
the one library of ``cuda_vecchia.build``, which also declares its entry
points.
"""
import ctypes

import torch

from . import cuda_vecchia as cv
from . import linalg, moments

#: bytes of per-tile partial sums one launch may hold; a call with more
#: queries launches once per chunk of them (at n = 2000 about 31,000 float64
#: queries a launch)
SCRATCH_BUDGET = 256 * 2**20

#: bytes of (n, n) second moments that one batch of the plain version's
#: queries may hold (the JAX package's budget for a chunk of its ensemble)
LINK_BUDGET = int(1.5e9)


def linked_dense_t_plain(X, m, v, W, Rinv, a, length, *, name):
    """Plain version of K5: (mu, tr, quad), each (M,), from each query's
    (n, n) second moments.  The queries go in batches (the JAX package
    vmaps a one-query function) of as many as keep their (n, n) moments and
    two products of them within `LINK_BUDGET`."""
    batch = max(1, LINK_BUDGET // (3 * X.shape[0] ** 2 * X.element_size()))
    if m.shape[0] > batch:
        parts = [linked_dense_t_plain(X, m[s:s + batch], v[s:s + batch],
                                      None if W is None else W[s:s + batch], Rinv, a, length,
                                      name=name)
                 for s in range(0, m.shape[0], batch)]
        return tuple(torch.cat(p) for p in zip(*parts))
    I, J = moments.IJ(X, m, v, length, name)   # (M, n), (M, n, n)
    if W is not None:
        I = I * W
        J = J * (W[:, :, None] * W[:, None, :])
    tr = linalg.trace_prod(Rinv, J)
    mu = I @ a
    # J's quadratic form as a product and a sum over contiguous rows: each
    # query's value does not depend on how many queries the call holds
    quad = torch.sum((J @ a[:, None])[..., 0] * a, dim=-1)
    return mu, tr, quad


def _kernel_weights(X, m, v, W, length, name):
    """(Iw (M, n), row weights of J or None): I times W, and for matern2.5
    the deterministic dims' (z_v = 0) factors of J, I_i I_j per dim, folded
    into the row weights, as `moments.j_matern` takes them."""
    if name == "sexp":
        I = moments.i_sexp(X, m, v, length)
        Wj = W
    elif name == "matern2.5":
        per_dim = moments._i_matern_1d(m[:, None, :] - X, v[:, None, :], length)
        I = torch.prod(per_dim, dim=-1)
        det = torch.prod(torch.where(v[:, None, :] > 0.0, torch.ones_like(per_dim), per_dim),
                         dim=-1)
        Wj = det if W is None else W * det
    else:
        raise ValueError(f"unknown kernel name: {name}")
    return (I if W is None else I * W), Wj


def linked_dense_t(X, m, v, W, Rinv, a, length, *, name):
    """K5: (mu, tr, quad), each (M,), of M Gaussian queries (m, v (M, D))
    against a dense node's training inputs X (n, D), with row weights W
    (M, n) or None, Rinv (n, n), a = Rinv_y (n,) and lengthscales (D,)."""
    if X.device.type == "cpu":
        return linked_dense_t_plain(X, m, v, W, Rinv, a, length, name=name)
    if X.device.type != "cuda":
        raise ValueError(f"linked_dense_t: unsupported device {X.device}")
    n, D = X.shape
    M = m.shape[0]
    if m.shape != (M, D) or v.shape != (M, D) or length.shape != (D,):
        raise ValueError("linked_dense_t: m and v must be (M, D) and length (D,) for X (n, D)")
    if Rinv.shape != (n, n) or a.shape != (n,) or (W is not None and W.shape != (M, n)):
        raise ValueError("linked_dense_t: Rinv must be (n, n), a (n,) and W (M, n)")
    tensors = (X, m, v, Rinv, a, length) + (() if W is None else (W,))
    cv._check_cuda("linked_dense_t", tensors, X.dtype, X.device)
    kw = dict(dtype=X.dtype, device=X.device)
    mu, tr, quad = (torch.empty((M,), **kw) for _ in range(3))
    if M == 0 or n == 0:
        return mu, tr, quad
    Iw, Wj = _kernel_weights(X, m, v, W, length, name)
    X, m, v, length, Iw, Rinv, a = (t.contiguous() for t in (X, m, v, length, Iw, Rinv, a))
    Wj = None if Wj is None else Wj.contiguous()
    lib = cv._library()
    tiles = lib.dgp_linked_dense_tiles(n)
    chunk = max(1, SCRATCH_BUDGET // (tiles * 2 * X.element_size()))
    part = torch.empty((min(M, chunk), tiles, 2), **kw)
    dev = X.device
    for s in range(0, M, chunk):
        k = min(chunk, M - s)
        with torch.cuda.device(dev):
            err = lib.dgp_linked_dense(
                cv._DTYPE[X.dtype], cv._KNAME[name], X.data_ptr(), m[s].data_ptr(),
                v[s].data_ptr(), length.data_ptr(), None if Wj is None else Wj[s].data_ptr(),
                Iw[s].data_ptr(), a.data_ptr(), Rinv.data_ptr(), part.data_ptr(),
                mu[s].data_ptr(), tr[s].data_ptr(), quad[s].data_ptr(), n, D, k,
                cv._stream(dev))
        if err != 0:
            raise RuntimeError(f"linked_dense_t: kernel launch failed (cudaError {err})")
        cv._launched("K5", dev)
    return mu, tr, quad


def launch_plan(dtype, name, D):
    """How K5 launches at D dims in ``dtype``: threads per thread block,
    its shared bytes, and the blocks one SM holds."""
    out = (ctypes.c_int * 3)()
    err = cv._library().dgp_linked_dense_plan(cv._DTYPE[dtype], cv._KNAME[name], D,
                                              ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"linked_dense_t: launch plan failed (cudaError {err})")
    return {"threads_per_block": out[0], "shared_bytes": out[1], "blocks_per_sm": out[2]}
