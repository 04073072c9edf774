"""Time the hand-written kernels of a dgp_tpu_torch checkout on one CUDA
device, by chip_smoke.py's method, so that two commits' kernels can be
compared by one method in one chip call.

The inputs, the library yardstick, the bound and the timing code are this
repository's chip_smoke.py (the main path's shapes, sexp: K1 (2, 26, 2,
2000) with 2 length lanes and the nugget lane, K2 (26, 2, 2000) with K=9,
dl=1, K3 (26, 1, 2000), K4 (26, 2, 2000) alone and with 9 candidates, and
the gp path's K1 without a node axis and K4, both at (26, 1, 2000); then
its VARIANT_TIMES, each kernel at m1 = 41, 48, 63 and 64 and K1 with 12
and 16 length lanes, where the checkout's kernels take them; float64 and
float32; and K5, the dense linked moments, at the lgp_n2000.predict
cell's dense call, M = 250, n = 2000, Dw = 2, sexp and matern2.5, beside
its plain version in gp_core's batches); the
kernels are those of the checkout given.  For
each case it measures CUDA-event time around 10 calls back to back and
around one call alone (median of 20 each) and the host time per call (200
calls queued without waiting); the first and the last again with the
inputs made contiguous beforehand (the path's blocks may be views, which
the wrapper copies); then the device time per call under
torch.profiler (mean over 20 calls), and the same for
torch.linalg.cholesky_ex of the same blocks.  Each case also records the
SHA-256 of the kernel's outputs on its inputs, so that two checkouts'
outputs can be compared bit for bit.  Prints the card's name and power
limit, then one JSON line.  Usage, from the repository root:

    python3 tools/kernel_times_torch.py [CHECKOUT] [LABEL] [--large] [--only=NAMES]

CHECKOUT (default: this repository) is the root of a checkout whose
dgp_tpu_torch is timed; it must take chip_smoke.py's inputs.  With
``--large`` it times, instead, the four kernels at chip_smoke.py's n = 1e5
cases (its `_large_inputs`: the large_n phase's data and IVF neighbours),
in float64 and float32.  ``--only=NAMES`` (wrapper names, comma-separated)
times those kernels alone.  Every case also reports the kernel's launch
plan (points per thread block, shared bytes, blocks and warps per SM), and
the line holds ptxas's register and spill figures of every kernel built.
"""
import functools
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
CASES = (("block_nllik_grad_parts_t", "block_nllik_grad_parts_t",
          {"n_length": 2, "nugget_est": True}),
         ("block_loglik_multi_t", "block_loglik_multi_t", {"dl": 1}),
         ("cond_weights_t", "cond_weights_t", {}),
         ("block_loglik_parts_t", "block_loglik_parts_t", {}),
         ("block_loglik_parts_t", "block_loglik_parts_t/K=9", {}),
         ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/gp",
          {"n_length": 1, "nugget_est": True}),
         ("block_loglik_parts_t", "block_loglik_parts_t/gp", {}))
LARGE_CASES = (("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/n1e5",
                {"n_length": 2, "nugget_est": True}),
               ("block_loglik_multi_t", "block_loglik_multi_t/n1e5", {"dl": 1}),
               ("cond_weights_t", "cond_weights_t/n1e5", {}),
               ("block_loglik_parts_t", "block_loglik_parts_t/n1e5", {}))


def device_ms(fn, symbol=None, reps=20):
    """Device time (ms) per call of ``fn``: the summed duration of the
    kernels it ran (those whose name contains ``symbol``, if given) over
    ``reps`` calls under torch.profiler, divided by ``reps``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"
          and (symbol is None or symbol in e.name)]
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3 if ev else None


def host_ms(fn, reps=200):
    """Host time (ms) per call of ``fn``, calls queued back to back without
    waiting for the device (stops well before the launch queue fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def outputs_sha256(fn):
    """SHA-256 of the bytes of every tensor ``fn`` returns."""
    out = fn()
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main():
    if not torch.cuda.is_available():
        print("kernel_times_torch: CUDA is not available", file=sys.stderr)
        return 1
    large = "--large" in sys.argv
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    only = set(only[0]) if only else None
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    checkout = Path(args[0]).resolve() if args else ROOT
    label = args[1] if len(args) > 1 else str(checkout)
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    if not Path(cv.__file__).resolve().is_relative_to(checkout):
        raise SystemExit(f"dgp_tpu_torch came from {cv.__file__}, not {checkout}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cv.build()
    calls = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        ins = (cs._large_inputs if large else cs._slice_inputs)(dt, dev, cs.NUGGET_BENCH)
        for kname, case, kw in LARGE_CASES if large else CASES:
            if only and kname not in only:
                continue
            args = ins[case]
            blocks = cs._blocks_of(kname, args)
            dense = [a.contiguous() for a in args]
            calls[f"{dname}/{case}"] = (
                kname, functools.partial(getattr(cv, kname), *args, **kw, name="sexp"),
                functools.partial(getattr(cv, kname), *dense, **kw, name="sexp"),
                functools.partial(torch.linalg.cholesky_ex, blocks),
                cs._bound_ms(kname, args, dname, kw), list(args[0].shape),
                [a.is_contiguous() for a in args])
        # chip_smoke.py's timed cases beyond the main path (blocks of two
        # rows per lane, K1 with 12 and 16 length lanes), where this checkout's
        # kernels take them
        for kname, shape in () if large else cs.VARIANT_TIMES:
            if only and kname not in only:
                continue
            kw = cs._edge_kw(kname, shape, "sexp")
            args = [torch.as_tensor(a, dtype=dt, device=dev)
                    for a in cs._edge_inputs(kname, shape, 0)]
            call = functools.partial(getattr(cv, kname), *args, **kw)
            try:
                call()
            except NotImplementedError:
                continue
            calls[f"{dname}/{kname}/{list(shape)}"] = (
                kname, call, call,
                functools.partial(torch.linalg.cholesky_ex, cs._blocks_of(kname, args)),
                cs._bound_ms(kname, args, dname, kw), list(args[0].shape),
                [a.is_contiguous() for a in args])
    plans = {key: cv.launch_plan(kname, getattr(torch, key.split("/")[0]), *shape[-3:-1])
             for key, (kname, _, _, _, _, shape, _) in calls.items()}
    times = {}
    for key, (kname, call, dense, library, (bound, by), shape, flat) in calls.items():
        times[key] = {"plan": plans[key], "out_sha256": outputs_sha256(call),
            "ms": cs.cuda_ms(call), "ms_one_call": cs.cuda_ms(call, inner=1),
            "host_ms": host_ms(call), "ms_contiguous": cs.cuda_ms(dense),
            "host_ms_contiguous": host_ms(dense), "library_ms": cs.cuda_ms(library),
            "library_ms_one_call": cs.cuda_ms(library, inner=1),
            "library_host_ms": host_ms(library),
            "bound_ms": bound, "bound_by": by, "shape": shape, "inputs_contiguous": flat}
    # K5, the dense linked moments, at the lgp_n2000.predict cell's shape
    # (chip_smoke.LINKED_SHAPE), sexp and matern2.5, where the checkout has it
    try:
        from dgp_tpu_torch.ops import cuda_linked as cl
    except ImportError:
        cl = None
    linked = {}
    if cl is not None and not large and (only is None or "linked_dense_t" in only):
        M, n, D = cs.LINKED_SHAPE
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[1]
            for name in ("sexp", "matern2.5"):
                args = cs._linked_dense_inputs(name, M, n, D, False, dt, dev)
                call = functools.partial(cl.linked_dense_t, *args, name=name)
                bound, by = cs._linked_bound_ms(M, n, D, dname)
                linked[f"{dname}/linked_dense_t/{name}"] = call
                times[f"{dname}/linked_dense_t/{name}"] = {
                    "plan": cl.launch_plan(dt, name, D), "out_sha256": outputs_sha256(call),
                    "ms": cs.cuda_ms(call, reps=5, inner=3),
                    "ms_one_call": cs.cuda_ms(call, inner=1), "host_ms": host_ms(call, reps=50),
                    "plain_ms": cs.cuda_ms(functools.partial(cl.linked_dense_t_plain, *args,
                                                             name=name),
                                           reps=2, warm=1, inner=1),
                    "bound_ms": bound, "bound_by": by, "shape": [M, n, D]}
    # profiled last: after a profiler session the calls timed in the same
    # process took about twice as long on the host
    for key, (kname, call, _, library, _, _, _) in calls.items():
        times[key].update(device_ms=device_ms(call, cs.KERNEL_SYMBOLS[kname]),
                          library_device_ms=device_ms(library))
    for key, call in linked.items():
        times[key].update(device_ms=device_ms(call, "linked_dense"), device_ms_all=device_ms(call))
    print(json.dumps({"checkout": label, "nvidia_smi": smi,
                      "ptxas": cv.build_info["ptxas"], "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
