"""Hand-written Hopper kernels for the Vecchia blocks, with their plain
PyTorch versions and the block-layout helpers; the counterpart of
`dgp_tpu/ops/pallas_vecchia.py`.

All four TPU kernels are ported (CUDA C++ in ../csrc, built with nvcc for
sm_90a into one shared library with a plain C interface and loaded with
ctypes):

  * K1 `block_nllik_grad_parts_t` <- pallas_vecchia.block_nllik_grad_parts_t
  * K2 `block_loglik_multi_t`     <- pallas_vecchia.block_loglik_multi_t
  * K3 `cond_weights_t`           <- pallas_vecchia.cond_weights_t
  * K4 `block_loglik_parts_t`     <- pallas_vecchia.block_loglik_parts_t

All take the JAX package's transposed layout: blocks (m1, d, n) with the
point axis last and coordinates pre-scaled by the lengthscales; diagonals
and targets (m1, n).  K1 takes a leading node axis (G, ...) and K4 an
optional leading candidate axis (K, ...): one launch serves what the JAX
package vmaps.  Invalid neighbour lanes carry sentinel coordinates
(far from everything, including each other), a unit diagonal and a zero
target, which decouples them exactly.

`use_kernel` is the gate, the counterpart of `pallas_vecchia.use_pallas`:
from the kernel's id, the block shape and the dtype alone (never the
device) it says whether the hand kernel takes a call -- m1 <= `M1_MAX` = 64,
as the JAX package's kernels take (one row per lane up to 32, two above),
for K1 any number of length lanes, and staged tiles that fit one SM's
shared memory (`shared_bytes`, the sources' own formula).  Every wrapper
asks it first.  A CPU tensor always goes to the plain version (`*_plain`);
outside the bound that adds one to the counter ``kernel.plain_calls.<id>``
(`tracing`), so a run on the CPU shows which calls the card would refuse.
A CUDA tensor inside the bound goes to the kernel (adding one to
``kernel.launches.<id>`` and ``kernel.launches.<id>@<device>``;
`launch_counts` and `launch_counts_by_device` read them); outside it the
wrapper raises NotImplementedError before anything is built: no plain
version runs on the card in a kernel's place.  The callers do not send such
blocks here: as the JAX package hands blocks above 64 rows to XLA, they
take `vecchia.core`'s large-block route, decided by the same gate.  Any
other device raises, and a kernel that fails to
build or to launch raises too: the gate decides on shape, it is not a
fallback.  The library is built at first use into
``dgp_tpu_torch/_build/`` from the sources in the package; nothing is
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

from .. import tracing
from . import kernels as kops
from . import linalg

#: largest block size (m + 1) the kernels take, as the JAX package's
#: (`pallas_vecchia.use_pallas`); the sources are compiled with the same
#: bound (-DDGP_M1_MAX)
M1_MAX = 64

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
#: csrc/vecchia_warp.cuh: most points (warps) of a thread block, the lanes
#: of a warp, the dynamic shared memory a launch gets without opting in, and
#: the most one SM gives a thread block (sm_90)
_WARPS_MAX, _WARP = 8, 32
_SMEM_DEFAULT, SMEM_MAX = 48 * 1024, 227 * 1024

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    """Tag of the library: the flags and every source and header under
    csrc/."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
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
    sources = sorted(_CSRC.glob("*.cu"))
    so = _BUILD / f"libdgp_vecchia_{tag}.so"
    log = _BUILD / f"libdgp_vecchia_{tag}.ptxas.txt"
    seconds = 0.0
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
            # one nvcc per source, all started together, then one link
            objs = [os.path.join(tmpdir, src.name + ".o") for src in sources]
            procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", obj],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(sources, objs)]
            outs = [p.communicate()[0] for p in procs]
            if any(p.returncode != 0 for p in procs):
                raise RuntimeError("nvcc failed:\n" + "\n".join(outs))
            tmp = os.path.join(tmpdir, "lib.so")
            res = subprocess.run([nvcc, "-shared", *_NVCC_FLAGS[:2], "-o", tmp, *objs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
            log.write_text("\n".join(outs))
            os.replace(tmp, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dgp_cond_weights.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.dgp_cond_weights.restype = ci
    lib.dgp_block_loglik_multi.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp,
                                           vp, vp, ci, ci, ci, ci, ci, vp]
    lib.dgp_block_loglik_multi.restype = ci
    lib.dgp_block_loglik_parts.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, ci, ci,
                                           ci, ci, vp]
    lib.dgp_block_loglik_parts.restype = ci
    lib.dgp_block_nllik_grad.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp,
                                         ci, ci, ci, ci, ci, ci, vp]
    lib.dgp_block_nllik_grad.restype = ci
    for fn in (lib.dgp_block_nllik_grad_plan, lib.dgp_block_loglik_multi_plan,
               lib.dgp_cond_weights_plan, lib.dgp_block_loglik_parts_plan):
        fn.argtypes = [ci, ci, ci, vp]
        fn.restype = ci
    lib.dgp_vecchia_m1_max.argtypes = []
    lib.dgp_vecchia_m1_max.restype = ci
    # K6 (csrc/vecchia_pred.cu; its wrappers are in cuda_pred)
    lib.dgp_vecchia_pred.argtypes = [ci, ci, ci, vp, vp, vp, vp, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_double, ctypes.c_double, vp,
                                     ci, ci, ci, ci, ci, vp]
    lib.dgp_vecchia_pred.restype = ci
    lib.dgp_vecchia_pred_plan.argtypes = [ci, ci, ci, ci, vp]
    lib.dgp_vecchia_pred_plan.restype = ci
    # K5 (csrc/linked_dense.cu; its wrapper is cuda_linked.linked_dense_t)
    lib.dgp_linked_dense.argtypes = [ci, ci] + [vp] * 12 + [ci, ci, ci, vp]
    lib.dgp_linked_dense.restype = ci
    lib.dgp_linked_dense_tiles.argtypes = [ci]
    lib.dgp_linked_dense_tiles.restype = ci
    lib.dgp_linked_dense_plan.argtypes = [ci, ci, ci, vp]
    lib.dgp_linked_dense_plan.restype = ci
    if lib.dgp_vecchia_m1_max() != M1_MAX:
        raise RuntimeError("kernel library was built with another block bound")
    build_info.clear()
    build_info.update(library=str(so), seconds=seconds,
                      ptxas=parse_ptxas(log.read_text() if log.exists() else ""))
    _lib = lib
    return lib


def _library():
    """The loaded library, built at first use."""
    return _lib if _lib is not None else build()


def _block_scratch(m1, keep):
    """`block_scratch` of csrc/vecchia_warp.cuh: one row per lane, the
    (m1, LDS) block and two column buffers; two, a (32, LDS) array, L11's
    (m1 - 32, LDS), the column buffers and ``keep`` more (m1 - 32, LDS)
    arrays: L21's from 1 (`KEEP_L`) on, A21's at 2 (`KEEP_LK`)."""
    lds = _WARP + 1
    if m1 <= _WARP:                                         # rows_per_lane
        return m1 * lds + 2 * _WARP
    return _WARP * lds + (1 + keep) * (m1 - _WARP) * lds + 2 * _WARP


def _per_point(kid, m1, d):
    """Values one point keeps in shared memory: `grad_per_point`,
    `multi_per_point`, `condw_per_point`, `parts_per_point` and
    `pred_per_point` of the sources, at the rows per lane (R) the launchers
    pick for m1.  K1's are its X tile, y, diag and dnug, the block with a
    copy of its correlations, and (one row per lane) 1 / L[j][j] and z; a =
    K^-1 y goes over the staged diag, which the kernel reads once.  K6's
    (one query, d = all its dims) its scaled and raw tiles, the rows' flags,
    a and weights, the query's constants and the block with L kept."""
    one = m1 <= _WARP                                       # rows_per_lane(m1) == 1
    if kid == "K1":
        return m1 * d + 3 * m1 + _block_scratch(m1, 2) + (2 * _WARP if one else 0)
    if kid == "K2":
        return 3 * m1 * d + 2 * m1 + d * m1 + _block_scratch(m1, 0)
    if kid == "K3":
        return m1 * d + m1 + (m1 - 1) + _block_scratch(m1, 1) + (_WARP if one else 0)
    if kid == "K4":
        return m1 * d + 2 * m1 + _block_scratch(m1, 0)
    if kid == "K6":
        return m1 * (2 * d + 3) + 3 * d + _block_scratch(m1, 1) + (_WARP if one else 0)
    raise ValueError(f"unknown kernel id: {kid}")


def shared_bytes(kid, m1, d, dtype):
    """Dynamic shared bytes of kernel ``kid``'s thread block at (m1, d):
    `plan_block` of csrc/vecchia_warp.cuh in Python, so that the gate needs
    no built library (`launch_plan` reports the library's own figure)."""
    per_point = _per_point(kid, m1, d) * (torch.finfo(dtype).bits // 8)
    w = _WARPS_MAX
    while w > 1 and w * per_point > _SMEM_DEFAULT:
        w //= 2
    return w * per_point


def use_kernel(kid, m1, d, dtype=torch.float64):
    """The gate: whether the hand kernel ``kid`` ("K1" .. "K4", "K6") takes blocks
    of m1 rows and d dims in ``dtype``.  Decided from these alone, so it
    reads the same on every device.  K1 takes any number of length lanes
    up to d (the wrapper refuses more as an invalid call), so they do not
    enter the decision."""
    if m1 > M1_MAX:
        return False
    return shared_bytes(kid, m1, d, dtype) <= SMEM_MAX


def _runs_plain(wrapper, kid, t, m1, d):
    """Whether ``wrapper``'s call on tensor ``t`` runs the plain version: a
    CPU tensor does (counted in ``kernel.plain_calls.<kid>`` when the gate
    says the kernel would not take it); a tensor on another device outside
    the kernel's bound is refused."""
    inside = use_kernel(kid, m1, d, t.dtype)
    if t.device.type == "cpu":
        if not inside:
            tracing.count("kernel.plain_calls." + kid)
        return True
    if not inside:
        raise NotImplementedError(
            f"{wrapper.__name__}: blocks of m1={m1} rows, d={d} dims in {t.dtype} are"
            f" outside the hand kernel's bound (m1 <= {M1_MAX}, staged tiles within"
            f" {SMEM_MAX} bytes of shared memory), and the plain version does not run"
            f" in its place on {t.device.type}: use m <= {M1_MAX - 1} or device='cpu'")
    return False


def launches(kid, t, m1, d):
    """Whether a call on tensor ``t`` launches the hand kernel ``kid``, for
    an entry point that sends every other call to its plain version (K6): a
    tensor off the CPU inside the gate does.  A CPU call outside the gate
    counts in ``kernel.plain_calls.<kid>``."""
    inside = use_kernel(kid, m1, d, t.dtype)
    if t.device.type == "cpu":
        if not inside:
            tracing.count("kernel.plain_calls." + kid)
        return False
    return inside


def launch_plan(kname, dtype, m1, d):
    """How the kernel ``kname`` (the name of its wrapper, e.g.
    "cond_weights_t") launches at (m1, d) in ``dtype``: points (warps) per
    thread block, its shared bytes, and the blocks and warps one SM holds
    (registers, shared memory and warps together)."""
    lib = _library()
    fn = {"block_nllik_grad_parts_t": lib.dgp_block_nllik_grad_plan,
          "block_loglik_multi_t": lib.dgp_block_loglik_multi_plan,
          "cond_weights_t": lib.dgp_cond_weights_plan,
          "block_loglik_parts_t": lib.dgp_block_loglik_parts_plan}[kname]
    out = (ctypes.c_int * 3)()
    err = fn(_DTYPE[dtype], m1, d, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{kname}: launch plan failed (cudaError {err})")
    return {"warps_per_block": out[0], "shared_bytes": out[1],
            "blocks_per_sm": out[2], "warps_per_sm": out[0] * out[2]}


def _check_cuda(name, tensors, dtype, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all tensors must lie on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: all tensors must be {dtype}, got {t.dtype}")
    if dtype not in _DTYPE:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got {dtype}")


def _stream(device):
    """The current stream of ``device``, the card a launch goes to (the
    wrappers make it the current device around the launch)."""
    return torch.cuda.current_stream(device).cuda_stream


def _launched(kid, device):
    """Count one launch of the kernel ``kid`` on ``device``."""
    tracing.count("kernel.launches." + kid)
    tracing.count(f"kernel.launches.{kid}@{device}")


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


def block_loglik_parts_t_plain(Xg, yg, diag, *, name):
    """Plain version of K4: (logdet (..., n), quad (..., n)) of (..., m1, d,
    n) blocks; yg and diag are (m1, n) or (..., m1, n)."""
    K = kops.set_diag(_corr_blocks(Xg, name), diag.transpose(-1, -2))
    L = linalg.chol_small(K)
    sol = linalg.fwd_solve_small(L, torch.broadcast_to(yg.transpose(-1, -2),
                                                       K.shape[:-1]))
    return 2.0 * torch.log(L[..., -1, -1]), sol[..., -1] ** 2


def block_nllik_grad_parts_t_plain(Xg, yg, diag, dnug, *, name, n_length,
                                   nugget_est):
    """Plain version of K1, the same analytic gradient batched over the
    points: (logdet (..., n), quad (..., n), dlogdet (..., p, n), dquad
    (..., p, n)) of (..., m1, d, n) blocks."""
    X = Xg.movedim(-1, -3)                                   # (..., n, m1, d)
    diff = X[..., :, None, :] - X[..., None, :, :]           # (..., n, m1, m1, d)
    if name == "sexp":
        sq = diff * diff
        Kc = torch.exp(-sq.sum(-1))
        per_dim = 2.0 * sq                  # dK/dlog l_t = 2 u_t^2 K
    elif name == "matern2.5":
        a = diff.abs()
        c = 1.0 + kops.SQRT5 * a + (5.0 / 3.0) * a * a
        Kc = torch.prod(c, dim=-1) * torch.exp(-kops.SQRT5 * a.sum(-1))
        per_dim = (5.0 / 3.0) * a * a * (1.0 + kops.SQRT5 * a) / c
    else:
        raise ValueError(f"unknown kernel name: {name}")
    dd = per_dim.sum(-1, keepdim=True) if n_length == 1 else per_dim[..., :n_length]
    L = linalg.chol_small(kops.set_diag(Kc, diag.transpose(-1, -2)))
    Ly = linalg.fwd_solve_small(L, yg.transpose(-1, -2))      # (..., n, m1)
    e_last = torch.zeros_like(Ly)
    e_last[..., -1] = 1.0
    z = linalg.bwd_solve_small(L, e_last)                     # L^-T e_last
    # dK_k z for every lane k (the diagonal of dd is 0)
    V = torch.einsum('...ajk,...j->...ak', dd * Kc[..., None], z)
    if nugget_est:
        V = torch.cat([V, (dnug.transpose(-1, -2) * z)[..., None]], dim=-1)
    W = torch.linalg.solve_triangular(L, V, upper=False)      # (..., n, m1, p)
    yl = Ly[..., -1:]
    wl = W[..., -1, :]                                        # (..., n, p)
    s = (Ly[..., None] * W).sum(-2)
    dquad = 2.0 * s * yl - wl * yl ** 2
    # contiguous, as the kernel's outputs: a sum over the points then adds
    # in the same order whether or not the points were split into shares
    return (2.0 * torch.log(L[..., -1, -1]), yl[..., 0] ** 2,
            wl.movedim(-1, -2).contiguous(), dquad.movedim(-1, -2).contiguous())


# ----------------------------------------------------------------------
# public wrappers
# ----------------------------------------------------------------------
def cond_weights_t(Xg, diag, *, name):
    """K3: conditional weights (w (m1-1, n), sigma (n,)) of (m1, d, n)
    blocks with (m1, n) diagonals."""
    m1, d, n = Xg.shape
    if _runs_plain(cond_weights_t, "K3", Xg, m1, d):
        return cond_weights_t_plain(Xg, diag, name=name)
    if diag.shape != (m1, n):
        raise ValueError(f"cond_weights_t: diag shape {tuple(diag.shape)} != {(m1, n)}")
    if Xg.device.type != "cuda":
        raise ValueError(f"cond_weights_t: unsupported device {Xg.device}")
    _check_cuda("cond_weights_t", (Xg, diag), Xg.dtype, Xg.device)
    Xg, diag = Xg.contiguous(), diag.contiguous()
    w = torch.empty((m1 - 1, n), dtype=Xg.dtype, device=Xg.device)
    sigma = torch.empty((n,), dtype=Xg.dtype, device=Xg.device)
    if n == 0:
        return w, sigma
    lib = _library()
    dev = Xg.device
    with torch.cuda.device(dev):
        err = lib.dgp_cond_weights(_DTYPE[Xg.dtype], _KNAME[name], Xg.data_ptr(),
                                   diag.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                                   m1, d, n, _stream(Xg.device))
    if err != 0:
        raise RuntimeError(f"cond_weights_t: kernel launch failed (cudaError {err})")
    _launched("K3", dev)
    return w, sigma


def block_loglik_multi_t(A, B, C, yg, diag, cosv, sinv, *, name, dl=None):
    """K2: (logdet (K, n), quad (K, n)) of the K candidate blocks
    cos*A + sin*B + C.  A/B/C: (m1, d, n); yg/diag: (m1, n); cosv/sinv:
    (K,).  ``dl`` is the number of leading candidate-dependent dims (the
    rest are static and factored out); defaults to all dims."""
    m1, d, n = A.shape
    if _runs_plain(block_loglik_multi_t, "K2", A, m1, d):
        return block_loglik_multi_t_plain(A, B, C, yg, diag, cosv, sinv,
                                          name=name, dl=dl)
    if dl is None:
        dl = d
    if B.shape != A.shape or C.shape != A.shape:
        raise ValueError("block_loglik_multi_t: A, B and C must share one shape")
    if yg.shape != (m1, n) or diag.shape != (m1, n):
        raise ValueError("block_loglik_multi_t: yg and diag must be (m1, n)")
    cosv = torch.as_tensor(cosv, dtype=A.dtype, device=A.device)
    sinv = torch.as_tensor(sinv, dtype=A.dtype, device=A.device)
    if cosv.ndim != 1 or sinv.shape != cosv.shape:
        raise ValueError("block_loglik_multi_t: cosv and sinv must be (K,)")
    if A.device.type != "cuda":
        raise ValueError(f"block_loglik_multi_t: unsupported device {A.device}")
    K = cosv.shape[0]
    _check_cuda("block_loglik_multi_t", (A, B, C, yg, diag, cosv, sinv),
                A.dtype, A.device)
    A, B, C, yg, diag, cosv, sinv = (t.contiguous() for t in
                                     (A, B, C, yg, diag, cosv, sinv))
    logdet = torch.empty((K, n), dtype=A.dtype, device=A.device)
    quad = torch.empty((K, n), dtype=A.dtype, device=A.device)
    if n == 0 or K == 0:
        return logdet, quad
    lib = _library()
    dev = A.device
    with torch.cuda.device(dev):
        err = lib.dgp_block_loglik_multi(
            _DTYPE[A.dtype], _KNAME[name], A.data_ptr(), B.data_ptr(), C.data_ptr(),
            yg.data_ptr(), diag.data_ptr(), cosv.data_ptr(), sinv.data_ptr(),
            logdet.data_ptr(), quad.data_ptr(), m1, d, int(dl), n, K,
            _stream(A.device))
    if err != 0:
        raise RuntimeError(f"block_loglik_multi_t: kernel launch failed (cudaError {err})")
    _launched("K2", dev)
    return logdet, quad


def block_loglik_parts_t(Xg, yg, diag, *, name):
    """K4: per-point (logdet, quad) at fixed parameters.  Xg is (m1, d, n),
    or (K, m1, d, n) for K candidate blocks in one launch; yg and diag are
    (m1, n) (shared by all candidates) or (K, m1, n).  Outputs (n,) or
    (K, n)."""
    if Xg.ndim not in (3, 4):
        raise ValueError("block_loglik_parts_t: Xg must be (m1, d, n) or (K, m1, d, n)")
    K, m1, d, n = (1,) + tuple(Xg.shape) if Xg.ndim == 3 else tuple(Xg.shape)
    if _runs_plain(block_loglik_parts_t, "K4", Xg, m1, d):
        return block_loglik_parts_t_plain(Xg, yg, diag, name=name)
    if yg.shape != diag.shape or tuple(yg.shape) not in ((m1, n), (K, m1, n)):
        raise ValueError("block_loglik_parts_t: yg and diag must both be (m1, n) "
                         "or (K, m1, n)")
    if Xg.device.type != "cuda":
        raise ValueError(f"block_loglik_parts_t: unsupported device {Xg.device}")
    _check_cuda("block_loglik_parts_t", (Xg, yg, diag), Xg.dtype, Xg.device)
    Xg, yg, diag = Xg.contiguous(), yg.contiguous(), diag.contiguous()
    out_shape = (n,) if Xg.ndim == 3 else (K, n)
    logdet = torch.empty(out_shape, dtype=Xg.dtype, device=Xg.device)
    quad = torch.empty(out_shape, dtype=Xg.dtype, device=Xg.device)
    if n == 0 or K == 0:
        return logdet, quad
    lib = _library()
    dev = Xg.device
    with torch.cuda.device(dev):
        err = lib.dgp_block_loglik_parts(
            _DTYPE[Xg.dtype], _KNAME[name], Xg.data_ptr(), yg.data_ptr(), diag.data_ptr(),
            logdet.data_ptr(), quad.data_ptr(), m1, d, n, K, int(yg.ndim == 2),
            _stream(Xg.device))
    if err != 0:
        raise RuntimeError(f"block_loglik_parts_t: kernel launch failed (cudaError {err})")
    _launched("K4", dev)
    return logdet, quad


def block_nllik_grad_parts_t(Xg, yg, diag, dnug, *, name, n_length, nugget_est):
    """K1: per-point (logdet, quad) and their gradients with respect to the
    n_length log-lengthscale lanes and, with ``nugget_est``, the log-nugget
    lane (p lanes in all).  Xg is (G, m1, d, n) for the G nodes of an
    M-step group (one launch), or (m1, d, n); yg, diag and dnug match it
    with (m1, n) blocks.  Returns (logdet (G, n), quad (G, n), dlogdet
    (G, p, n), dquad (G, p, n)), without the G axis for unbatched input.
    ``n_length`` is 1 (isotropic: one lane for all dims) or at most d."""
    if Xg.ndim not in (3, 4):
        raise ValueError("block_nllik_grad_parts_t: Xg must be (G, m1, d, n) or (m1, d, n)")
    m1, d = Xg.shape[-3:-1]
    n_length = int(n_length)
    if not (n_length == 1 or 1 <= n_length <= d):
        raise ValueError(f"block_nllik_grad_parts_t: n_length={n_length} must be 1 "
                         f"or at most d={d}")
    if _runs_plain(block_nllik_grad_parts_t, "K1", Xg, m1, d):
        return block_nllik_grad_parts_t_plain(Xg, yg, diag, dnug, name=name,
                                              n_length=n_length,
                                              nugget_est=nugget_est)
    single = Xg.ndim == 3
    if single:
        Xg, yg, diag, dnug = Xg[None], yg[None], diag[None], dnug[None]
    G, m1, d, n = Xg.shape
    for t in (yg, diag, dnug):
        if t.shape != (G, m1, n):
            raise ValueError(f"block_nllik_grad_parts_t: yg, diag and dnug must be "
                             f"{(G, m1, n)}, got {tuple(t.shape)}")
    if Xg.device.type != "cuda":
        raise ValueError(f"block_nllik_grad_parts_t: unsupported device {Xg.device}")
    _check_cuda("block_nllik_grad_parts_t", (Xg, yg, diag, dnug), Xg.dtype, Xg.device)
    Xg, yg, diag, dnug = (t.contiguous() for t in (Xg, yg, diag, dnug))
    npar = n_length + int(bool(nugget_est))
    kw = dict(dtype=Xg.dtype, device=Xg.device)
    logdet, quad = torch.empty((G, n), **kw), torch.empty((G, n), **kw)
    dlogdet, dquad = torch.empty((G, npar, n), **kw), torch.empty((G, npar, n), **kw)
    if n > 0 and G > 0:
        lib = _library()
        dev = Xg.device
        with torch.cuda.device(dev):
            err = lib.dgp_block_nllik_grad(
                _DTYPE[Xg.dtype], _KNAME[name], Xg.data_ptr(), yg.data_ptr(),
                diag.data_ptr(), dnug.data_ptr(), logdet.data_ptr(), quad.data_ptr(),
                dlogdet.data_ptr(), dquad.data_ptr(), m1, d, n, G, n_length,
                int(bool(nugget_est)), _stream(Xg.device))
        if err != 0:
            raise RuntimeError(f"block_nllik_grad_parts_t: kernel launch failed "
                               f"(cudaError {err})")
        _launched("K1", dev)
    out = (logdet, quad, dlogdet, dquad)
    return tuple(o[0] for o in out) if single else out


#: every kernel wrapper, by the name its launch count is reported under
WRAPPERS = (block_nllik_grad_parts_t, block_loglik_multi_t, cond_weights_t,
            block_loglik_parts_t)


#: the gate's id of each wrapper
KERNEL_ID = {"block_nllik_grad_parts_t": "K1", "block_loglik_multi_t": "K2",
             "cond_weights_t": "K3", "block_loglik_parts_t": "K4"}
#: the launch counts' id of each wrapper: the gated K1-K4, K5
#: (`cuda_linked.linked_dense_t`), which has no bound and so no plain calls,
#: and K6 (`cuda_pred.gp_vecch_t` and `link_gp_vecch_t`, one count), whose
#: plain calls are `vecchia.core`'s outside its bound
LAUNCH_ID = {**KERNEL_ID, "linked_dense_t": "K5", "vecchia_pred_t": "K6"}


def reset_launch_counts():
    tracing.reset("kernel.")


def launch_counts():
    """Per wrapper, since the last reset: the kernel launches, and the calls
    on CPU tensors that lay outside the kernel's bound (the counters
    ``kernel.launches.<id>`` and ``kernel.plain_calls.<id>``)."""
    t = tracing.totals("kernel.")
    return {name: {"launches": t.get("kernel.launches." + kid, 0),
                   "plain_calls": t.get("kernel.plain_calls." + kid, 0)}
            for name, kid in LAUNCH_ID.items()}


def launch_counts_by_device():
    """Per wrapper, since the last reset: the kernel launches by card (they
    sum to `launch_counts`' launches)."""
    t = tracing.totals("kernel.launches.")
    return {name: {k.partition("@")[2]: v for k, v in t.items()
                   if k.startswith(f"kernel.launches.{kid}@")}
            for name, kid in LAUNCH_ID.items()}


# ----------------------------------------------------------------------
# block-layout helpers (transposed (m1, ..., n) layout)
# ----------------------------------------------------------------------
def sentinels(n, m1, dtype, device, start=0):
    """(m1, n) sentinel coordinates for invalid neighbour lanes of the
    points start..start+n: far from every real point and from each
    other."""
    return (1e7 + torch.arange(start, start + n, dtype=dtype, device=device)[None, :] * 1e3
            + torch.arange(m1, dtype=dtype, device=device)[:, None] * 7e2)


def gather_scale_t(X, y, NNarray, length, nugget, nugget_diag, extra_jitter, start=0):
    """Gather and sentinel-encode Vecchia blocks directly in the kernels'
    (m1, d, n) layout, for the points whose neighbour rows NNarray holds
    (the points start.., all of X's by default).  X may carry leading
    candidate axes, (..., n, d), and then so does Xg.  Returns (Xg (...,
    m1, d, n), yg (m1, n), diag (m1, n))."""
    rev = torch.flip(NNarray, dims=(1,))
    validT = (rev >= 0).T                                   # (m1, n)
    safeT = torch.where(validT, rev.T, 0)
    n, m1 = NNarray.shape
    Xl = (X / length).transpose(-1, -2)                     # (..., d, n)
    Xg = Xl[..., safeT].transpose(-3, -2)                   # (..., m1, d, n)
    sent = sentinels(n, m1, Xg.dtype, Xg.device, start)
    Xg = torch.where(validT[:, None, :], Xg, sent[:, None, :])
    yg = torch.where(validT, y[safeT], 0.0)
    diag = torch.where(validT, 1.0 + nugget * nugget_diag[safeT] + extra_jitter, 1.0)
    return Xg, yg, diag


def gather_raw_t(X, y, NNarray, nugget_diag):
    """Index-only block gather in the transposed layout (no parameter
    dependence, so it runs once for the many evaluations of an M-step).
    Returns (Xg_raw (m1, d, n), yg (m1, n), nug_g (m1, n), valid (m1, n))."""
    rev = torch.flip(NNarray, dims=(1,))
    validT = (rev >= 0).T
    safeT = torch.where(validT, rev.T, 0)
    Xg_raw = X.T[:, safeT].transpose(0, 1)                  # (m1, d, n)
    yg = torch.where(validT, y[safeT], 0.0)
    nug_g = torch.where(validT, nugget_diag[safeT], 0.0)
    return Xg_raw, yg, nug_g, validT


def scale_blocks_t(Xg_raw, nug_g, valid, length, nugget, extra_jitter, start=0):
    """Per-evaluation transform in the transposed layout: scale by the
    lengthscales, sentinel-encode invalid lanes, build the diagonal.  A
    leading node axis is allowed: Xg_raw (..., m1, d, n), nug_g and valid
    (..., m1, n), length (..., d) and nugget (...); the points are
    start..start+n.  Returns (Xg (..., m1, d, n), diag (..., m1, n), dnug
    (..., m1, n))."""
    m1, d, n = Xg_raw.shape[-3:]
    nugget = torch.as_tensor(nugget, dtype=Xg_raw.dtype, device=Xg_raw.device)
    Xg = Xg_raw / length[..., None, :, None]
    sent = sentinels(n, m1, Xg.dtype, Xg.device, start)
    Xg = torch.where(valid[..., :, None, :], Xg, sent[:, None, :])
    nug = nugget[..., None, None]
    diag = torch.where(valid, 1.0 + nug * nug_g + extra_jitter, 1.0)
    dnug = nug * nug_g
    return Xg, diag, dnug
