"""Hand-written Hopper kernels for the Vecchia blocks, with their plain
PyTorch versions and the block-layout helpers; the counterpart of
`dgp_tpu/ops/pallas_vecchia.py`.

Two kernels are ported (CUDA C++ in ../csrc, built with nvcc for sm_90a
into a shared library with a plain C interface and loaded with ctypes):

  * K3 `cond_weights_t`       <- pallas_vecchia.cond_weights_t
  * K2 `block_loglik_multi_t` <- pallas_vecchia.block_loglik_multi_t

Both take the JAX package's transposed layout: blocks (m1, d, n) with the
point axis last and coordinates pre-scaled by the lengthscales; diagonals
and targets (m1, n).  Invalid neighbour lanes carry sentinel coordinates
(far from everything, including each other), a unit diagonal and a zero
target, which decouples them exactly.

Each public wrapper dispatches on the device of its tensors: a CPU tensor
goes to the plain version (`*_plain`), a CUDA tensor to the kernel, and
anything the kernel cannot take raises.  The library is built at first use
into ``dgp_tpu_torch/_build/`` from the sources in the package; nothing is
compiled or loaded when this module is imported.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from . import kernels as kops
from . import linalg

#: largest block size (m + 1) the kernels take; the sources are compiled
#: with the same bound (-DDGP_M1_MAX).
M1_MAX = 32

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("cond_weights.cu", "block_loglik_multi.cu")
_HEADERS = ("vecchia_common.cuh",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               f"-DDGP_M1_MAX={M1_MAX}")
_KNAME = {"sexp": 0, "matern2.5": 1}
_DTYPE = {torch.float32: 0, torch.float64: 1}

_lib = None
#: what the last build or load reported: library path, build seconds (0.0
#: when a finished library was found), and the ptxas resource lines.
build_info = {}


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------
def _nvcc():
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of dgp_tpu_torch are "
                       "built at first use and need the CUDA toolkit")


def _source_hash():
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _HEADERS + _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def parse_ptxas(text):
    """Per-kernel ptxas resource lines -> list of dicts (name, registers,
    stack frame and spill bytes)."""
    out = []
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle.  Raises if nvcc is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    tag = _source_hash()
    so = _BUILD / f"libdgp_vecchia_{tag}.so"
    log = _BUILD / f"libdgp_vecchia_{tag}.ptxas.txt"
    seconds = 0.0
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
               *[str(_CSRC / s) for s in _SOURCES]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dgp_cond_weights.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.dgp_cond_weights.restype = ci
    lib.dgp_block_loglik_multi.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp,
                                           vp, vp, ci, ci, ci, ci, ci, vp]
    lib.dgp_block_loglik_multi.restype = ci
    lib.dgp_vecchia_m1_max.argtypes = []
    lib.dgp_vecchia_m1_max.restype = ci
    if lib.dgp_vecchia_m1_max() != M1_MAX:
        raise RuntimeError("kernel library was built with another M1_MAX")
    build_info.clear()
    build_info.update(library=str(so), seconds=seconds,
                      ptxas=parse_ptxas(log.read_text() if log.exists() else ""))
    _lib = lib
    return lib


def _check_cuda(name, tensors, dtype, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all tensors must lie on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: all tensors must be {dtype}, got {t.dtype}")
    if dtype not in _DTYPE:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {dtype}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# plain PyTorch versions (same signatures and layout as the kernels)
# ----------------------------------------------------------------------
def _corr_blocks(Xt, name):
    """(..., m1, d, n) pre-scaled coordinates -> (..., n, m1, m1)
    correlation blocks (the diagonal is 1 and gets replaced)."""
    X = Xt.movedim(-1, -3)                                   # (..., n, m1, d)
    one = torch.ones((), dtype=X.dtype, device=X.device)
    return kops.k_cross(X, X, one, name)


def cond_weights_t_plain(Xg, diag, *, name):
    """Plain version of K3: (w (m, n), sigma (n,))."""
    K = kops.set_diag(_corr_blocks(Xg, name), diag.T)
    L = linalg.chol_small(K)
    w = linalg.bwd_solve_small(L[:, :-1, :-1], L[:, -1, :-1])
    return w.T.contiguous(), L[:, -1, -1].contiguous()


def block_loglik_multi_t_plain(A, B, C, yg, diag, cosv, sinv, *, name, dl=None):
    """Plain version of K2: (logdet (K, n), quad (K, n))."""
    m1, d, n = A.shape
    if dl is None:
        dl = d
    cosv = torch.as_tensor(cosv, dtype=A.dtype, device=A.device)
    sinv = torch.as_tensor(sinv, dtype=A.dtype, device=A.device)
    c = cosv[:, None, None, None]
    s = sinv[:, None, None, None]
    if dl >= d or dl == 0:
        Kc = _corr_blocks(c * A + s * B + C, name)           # (K, n, m1, m1)
    else:
        lat = c * A[:, :dl] + s * B[:, :dl] + C[:, :dl]
        Kc = _corr_blocks(lat, name) * _corr_blocks(C[:, dl:], name)
    Kc = kops.set_diag(Kc, diag.T)
    L = linalg.chol_small(Kc)
    sol = linalg.fwd_solve_small(L, torch.broadcast_to(yg.T, Kc.shape[:-1]))
    return 2.0 * torch.log(L[..., -1, -1]), sol[..., -1] ** 2


# ----------------------------------------------------------------------
# public wrappers
# ----------------------------------------------------------------------
def cond_weights_t(Xg, diag, *, name):
    """K3: conditional weights (w (m1-1, n), sigma (n,)) of (m1, d, n)
    blocks with (m1, n) diagonals."""
    if Xg.device.type == "cpu":
        return cond_weights_t_plain(Xg, diag, name=name)
    if Xg.device.type != "cuda":
        raise ValueError(f"cond_weights_t: unsupported device {Xg.device}")
    m1, d, n = Xg.shape
    if m1 > M1_MAX:
        raise ValueError(f"cond_weights_t: m1={m1} exceeds the kernel bound {M1_MAX}")
    if diag.shape != (m1, n):
        raise ValueError(f"cond_weights_t: diag shape {tuple(diag.shape)} != {(m1, n)}")
    _check_cuda("cond_weights_t", (Xg, diag), Xg.dtype, Xg.device)
    Xg, diag = Xg.contiguous(), diag.contiguous()
    w = torch.empty((m1 - 1, n), dtype=Xg.dtype, device=Xg.device)
    sigma = torch.empty((n,), dtype=Xg.dtype, device=Xg.device)
    if n == 0:
        return w, sigma
    lib = build()
    err = lib.dgp_cond_weights(_DTYPE[Xg.dtype], _KNAME[name], Xg.data_ptr(),
                               diag.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                               m1, d, n, _stream(Xg.device))
    if err != 0:
        raise RuntimeError(f"cond_weights_t: kernel launch failed (cudaError {err})")
    cond_weights_t.launches += 1
    return w, sigma


cond_weights_t.launches = 0


def block_loglik_multi_t(A, B, C, yg, diag, cosv, sinv, *, name, dl=None):
    """K2: (logdet (K, n), quad (K, n)) of the K candidate blocks
    cos*A + sin*B + C.  A/B/C: (m1, d, n); yg/diag: (m1, n); cosv/sinv:
    (K,).  ``dl`` is the number of leading candidate-dependent dims (the
    rest are static and factored out); defaults to all dims."""
    if A.device.type == "cpu":
        return block_loglik_multi_t_plain(A, B, C, yg, diag, cosv, sinv,
                                          name=name, dl=dl)
    if A.device.type != "cuda":
        raise ValueError(f"block_loglik_multi_t: unsupported device {A.device}")
    m1, d, n = A.shape
    if dl is None:
        dl = d
    if m1 > M1_MAX:
        raise ValueError(f"block_loglik_multi_t: m1={m1} exceeds the kernel bound {M1_MAX}")
    if B.shape != A.shape or C.shape != A.shape:
        raise ValueError("block_loglik_multi_t: A, B and C must share one shape")
    if yg.shape != (m1, n) or diag.shape != (m1, n):
        raise ValueError("block_loglik_multi_t: yg and diag must be (m1, n)")
    cosv = torch.as_tensor(cosv, dtype=A.dtype, device=A.device)
    sinv = torch.as_tensor(sinv, dtype=A.dtype, device=A.device)
    if cosv.ndim != 1 or sinv.shape != cosv.shape:
        raise ValueError("block_loglik_multi_t: cosv and sinv must be (K,)")
    K = cosv.shape[0]
    _check_cuda("block_loglik_multi_t", (A, B, C, yg, diag, cosv, sinv),
                A.dtype, A.device)
    A, B, C, yg, diag, cosv, sinv = (t.contiguous() for t in
                                     (A, B, C, yg, diag, cosv, sinv))
    logdet = torch.empty((K, n), dtype=A.dtype, device=A.device)
    quad = torch.empty((K, n), dtype=A.dtype, device=A.device)
    if n == 0 or K == 0:
        return logdet, quad
    lib = build()
    err = lib.dgp_block_loglik_multi(
        _DTYPE[A.dtype], _KNAME[name], A.data_ptr(), B.data_ptr(), C.data_ptr(),
        yg.data_ptr(), diag.data_ptr(), cosv.data_ptr(), sinv.data_ptr(),
        logdet.data_ptr(), quad.data_ptr(), m1, d, int(dl), n, K,
        _stream(A.device))
    if err != 0:
        raise RuntimeError(f"block_loglik_multi_t: kernel launch failed (cudaError {err})")
    block_loglik_multi_t.launches += 1
    return logdet, quad


block_loglik_multi_t.launches = 0


def reset_launch_counts():
    cond_weights_t.launches = 0
    block_loglik_multi_t.launches = 0


# ----------------------------------------------------------------------
# block-layout helpers (transposed (m1, ..., n) layout)
# ----------------------------------------------------------------------
def sentinels(n, m1, dtype, device):
    """(m1, n) sentinel coordinates for invalid neighbour lanes: far from
    every real point and from each other."""
    return (1e7 + torch.arange(n, dtype=dtype, device=device)[None, :] * 1e3
            + torch.arange(m1, dtype=dtype, device=device)[:, None] * 7e2)


def gather_scale_t(X, y, NNarray, length, nugget, nugget_diag, extra_jitter):
    """Gather and sentinel-encode Vecchia blocks directly in the kernels'
    (m1, d, n) layout.  Returns (Xg (m1, d, n), yg (m1, n), diag (m1, n))."""
    rev = torch.flip(NNarray, dims=(1,))
    validT = (rev >= 0).T                                   # (m1, n)
    safeT = torch.where(validT, rev.T, 0)
    n, m1 = X.shape[0], NNarray.shape[1]
    Xl = (X / length).T                                     # (d, n)
    Xg = Xl[:, safeT].transpose(0, 1)                       # (m1, d, n)
    sent = sentinels(n, m1, Xg.dtype, Xg.device)
    Xg = torch.where(validT[:, None, :], Xg, sent[:, None, :])
    yg = torch.where(validT, y[safeT], 0.0)
    diag = torch.where(validT, 1.0 + nugget * nugget_diag[safeT] + extra_jitter, 1.0)
    return Xg, yg, diag


def scale_blocks_t(Xg_raw, nug_g, valid, length, nugget, extra_jitter):
    """Per-evaluation transform in the transposed layout: scale by the
    lengthscales, sentinel-encode invalid lanes, build the diagonal.
    Returns (Xg (m1, d, n), diag (m1, n), dnug (m1, n))."""
    m1, d, n = Xg_raw.shape
    Xg = Xg_raw / length[None, :, None]
    sent = sentinels(n, m1, Xg.dtype, Xg.device)
    Xg = torch.where(valid[:, None, :], Xg, sent[:, None, :])
    diag = torch.where(valid, 1.0 + nugget * nug_g + extra_jitter, 1.0)
    dnug = nugget * nug_g
    return Xg, diag, dnug
