"""K6 `vecchia_pred`: a Vecchia node's prediction as one hand-written Hopper
kernel a call (`csrc/vecchia_pred.cu`), in its two instantiations:

  * `gp_vecch_t`, kriging: the (k+1)-row block of each query's neighbours
    with the query last (`vecchia.core.gp_vecch`);
  * `link_gp_vecch_t`, the linked-GP moments over each query's k-row block
    (`vecchia.core.link_gp_vecch`).

Both take the arguments of their entry point as they stand: the training
arrays and the queries on the device (2-D arrays with unit column stride,
any row stride), the int64 neighbour rows NNarray (M, k) with -1 for an
invalid lane, and scale and nugget as numbers or as 0-d tensors on the
device, which the kernel reads there (no copy to the host).  They return
(mean (M,), var (M,)), views of one (2, M) array.  The plain versions are
the bodies the entry points run on the CPU and, outside K6's bound, on the
card (`vecchia.core.gp_vecch_plain`, `link_gp_vecch_plain`); the entry
points decide with the gate, ``cuda_vecchia.launches("K6", ...)``, so these
wrappers take CUDA tensors inside it alone.  Each launch counts in
``kernel.launches.K6`` and ``kernel.launches.K6@<device>``; a launch that
fails raises.  dgp_tpu has no kernel here, so K6 replaces none.
"""
import ctypes

import torch

from . import cuda_vecchia as cv


def _rows(t):
    """``t`` with unit column stride (a copy only if it has none)."""
    return t if t.ndim < 2 or t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _scalar(v, dtype, device):
    """(device pointer or None, value): a 0-d tensor stays where it is."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.device != device or v.dtype != dtype:
            raise ValueError("K6: a tensor scale or nugget must be one value of the "
                             "operands' dtype on their device")
        return v.data_ptr(), 0.0
    return None, float(v)


def _launch(linked, ptrs, strides, tensors, scale, nugget, extra, jitter, name, M, k, Dw,
            Dz, n):
    ref = tensors[0]
    dev, dtype = ref.device, ref.dtype
    if dev.type != "cuda":
        raise ValueError(f"K6: unsupported device {dev}")
    cv._check_cuda("vecchia_pred", [t for t in tensors if t.dtype != torch.int64], dtype, dev)
    out = torch.empty((2, M), dtype=dtype, device=dev)
    if M == 0:
        return out[0], out[1]
    scale_p, scale_v = _scalar(scale, dtype, dev)
    nugget_p, nugget_v = _scalar(nugget, dtype, dev)
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    s = (ctypes.c_longlong * len(strides))(*strides)
    lib = cv._library()
    with torch.cuda.device(dev):
        err = lib.dgp_vecchia_pred(cv._DTYPE[dtype], cv._KNAME[name], int(linked), p, s,
                                   scale_p, nugget_p, scale_v, nugget_v, float(extra),
                                   float(jitter), out.data_ptr(), M, k, Dw, Dz, n,
                                   cv._stream(dev))
    if err != 0:
        raise RuntimeError(f"vecchia_pred: kernel launch failed (cudaError {err})")
    cv._launched("K6", dev)
    return out[0], out[1]


def _nn(NNarray, device):
    if NNarray.device != device:
        raise ValueError(f"K6: NNarray must lie on {device}, got {NNarray.device}")
    return _rows(NNarray if NNarray.dtype == torch.int64 else NNarray.to(torch.int64))


def gp_vecch_t(x, w_train, NNarray, y, scale, length, nugget, nugget_diag, name,
               extra_jit=0.0, *, jitter):
    """K6, kriging: `vecchia.core.gp_vecch`'s (mean, var) of the queries x
    (M, d) from their neighbours NNarray (M, k) among w_train (n, d), with
    the float32 blocks' fixed diagonal ``jitter``."""
    M, k = NNarray.shape
    n, d = w_train.shape
    if x.shape != (M, d) or y.shape != (n,) or nugget_diag.shape != (n,) \
            or length.numel() not in (1, d):
        raise ValueError("gp_vecch_t: x must be (M, d), y and nugget_diag (n,) and length "
                         "(1,) or (d,) for w_train (n, d) and NNarray (M, k)")
    x, w_train = _rows(x), _rows(w_train)
    nn = _nn(NNarray, x.device)
    length = length.reshape(-1)
    tensors = (x, w_train, nn, y, nugget_diag, length)
    return _launch(False, [t.data_ptr() for t in tensors],
                   [x.stride(0), w_train.stride(0), nn.stride(0), y.stride(0),
                    nugget_diag.stride(0), int(length.numel() > 1) * length.stride(0)],
                   tensors, scale, nugget, extra_jit, jitter, name, M, k, d, 0, n)


def link_gp_vecch_t(m, v, z, w1, global_w1, NNarray, y, scale, length, nugget,
                    nugget_diag, name, extra_jit=0.0, *, jitter):
    """K6, linked: `vecchia.core.link_gp_vecch`'s (mu, var) of the Gaussian
    queries (m, v) (M, Dw), with the global input z (M, Dz) or None, from
    their neighbours NNarray (M, k) among w1 (n, Dw) and global_w1 (n, Dz),
    with the float32 blocks' fixed diagonal ``jitter``."""
    M, k = NNarray.shape
    n, Dw = w1.shape
    Dz = 0 if z is None else z.shape[1]
    if m.shape != (M, Dw) or v.shape != (M, Dw) or y.shape != (n,) \
            or nugget_diag.shape != (n,) or length.numel() not in (1, Dw + Dz) \
            or (z is None) != (global_w1 is None) \
            or (z is not None and (z.shape[0] != M or global_w1.shape != (n, Dz))):
        raise ValueError("link_gp_vecch_t: m and v must be (M, Dw), z (M, Dz) with "
                         "global_w1 (n, Dz) or both None, y and nugget_diag (n,) and length "
                         "(1,) or (Dw + Dz,) for w1 (n, Dw) and NNarray (M, k)")
    m, v, w1 = _rows(m), _rows(v), _rows(w1)
    z = None if z is None else _rows(z)
    global_w1 = None if global_w1 is None else _rows(global_w1)
    nn = _nn(NNarray, m.device)
    length = length.reshape(-1)
    tensors = tuple(t for t in (m, v, z, w1, global_w1, nn, y, nugget_diag, length)
                    if t is not None)
    ptrs = [None if t is None else t.data_ptr()
            for t in (m, v, z, w1, global_w1, nn, y, nugget_diag, length)]
    strides = [0 if t is None else t.stride(0)
               for t in (m, v, z, w1, global_w1, nn, y, nugget_diag)]
    strides.append(int(length.numel() > 1) * length.stride(0))
    return _launch(True, ptrs, strides, tensors, scale, nugget, extra_jit, jitter, name, M,
                   k, Dw, Dz, n)


def launch_plan(dtype, linked, m1, d):
    """How K6 launches at m1 block rows and d dims in ``dtype`` (``linked``:
    the linked instantiation, else kriging): queries (warps) per thread
    block, its shared bytes, and the blocks one SM holds."""
    out = (ctypes.c_int * 3)()
    err = cv._library().dgp_vecchia_pred_plan(cv._DTYPE[dtype], int(linked), m1, d,
                                              ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"vecchia_pred: launch plan failed (cudaError {err})")
    return {"warps_per_block": out[0], "shared_bytes": out[1], "blocks_per_sm": out[2],
            "warps_per_sm": out[0] * out[2]}
