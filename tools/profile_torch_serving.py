"""Profile dgp_tpu_torch's serving and training paths on one CUDA device
with torch.profiler.

Runs chip_smoke.py's main-path configuration (2-layer Vecchia DGP, n=2000,
m=25, hyper-parameters from dgp_tpu_torch/data/vecchia_si_n2000.json) once
to warm up, then profiles `emulator(..., N=5)` and `predict` on 20000
points separately; then trains chip_smoke.py's training configuration
(bench.py's starting hyper-parameters) for 48 warm-up iterations and
profiles 4 warm SEM iterations (`train(N=4)`, no NN refresh inside).  Then
chip_smoke.py's dense DGP (the parity row `2d`): 20 warm-up iterations and
5 profiled ones; and its gp phase's protocol: the dense `train()` and, after
`to_vecchia(m=25)`, the Vecchia `train()`.  For each window it prints one
JSON line: wall seconds, the summed device time of all kernels, their share
of the wall time, the kernel launches (all, and of each hand-written
kernel), each hand-written kernel's device milliseconds, and the top
operators by device time and by host time.  With a
directory argument it also writes each window's Chrome trace there.

With ``--linked`` it profiles chip_smoke.py's `linked` cell instead (the
GP -> DGP system of dgp_tpu_torch/data/linked_n2000.json at lgp seed 1,
N=10, m=50): after a warm-up on 64 points, one window of `lgp.predict` on
the 1000 test points.  Usage, from the repository root:

    python3 tools/profile_torch_serving.py [--linked] [TRACE_DIR]
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import dgp_tpu_torch  # noqa: E402
from dgp_tpu_torch import dgp, emulator, layers_from_numpy, nb_seed  # noqa: E402


def _top(events, key, n=12):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"op": e.key[:80], "calls": e.count,
             "self_device_ms": e.self_device_time_total / 1e3,
             "self_host_ms": e.self_cpu_time_total / 1e3} for e in rows]


def window(name, fn, out_dir):
    torch.cuda.synchronize()
    before = chip_smoke.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / f"profile_{name}.json"))
    ev = prof.key_averages()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    launches = {k: v - before[k] for k, v in chip_smoke.launch_counts().items()}
    kernel_ms = {k: sum(e.time_range.elapsed_us() for e in kernels if sym in e.name) / 1e3
                 for k, sym in chip_smoke.KERNEL_SYMBOLS.items()}
    all_launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    out = {"window": name, "wall_s": wall, "device_kernel_s": busy,
           "device_busy_share": busy / wall, "launches": launches,
           "kernel_device_ms": kernel_ms,
           "cuda_launch_kernel_calls": all_launches,
           "top_device": _top(ev, "self_device_time_total"),
           "top_host": _top(ev, "self_cpu_time_total")}
    print(json.dumps(out), flush=True)
    return out


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def linked(dev, out_dir):
    """chip_smoke.py's `linked` cell: one window of `lgp.predict`."""
    from dgp_tpu_torch import container, gp, kernel, lgp
    ref = chip_smoke._data_json("linked_n2000.json")
    p = ref["protocol"]
    X1, Y1, X2, Y2 = chip_smoke.linked_data(p)
    np.random.seed(p["gp_ord_seed"])
    g = gp(X1, Y1, kernel(length=np.array([p["gp_length"]]), name=p["gp_kernel"],
                          scale_est=True, nugget_est=True), vecchia=True, m=p["m"], device=dev)
    g.train()
    c1 = container(g.export(), local_input_idx=np.array([0]), device=dev)
    seed = p["lgp_seeds"][0]
    nb_seed(seed)
    np.random.seed(seed)
    m2 = dgp(X2, Y2, chip_smoke.linked_layers(ref), vecchia=True, m=p["m"], device=dev)
    c2 = container(m2.estimate(), local_input_idx=np.array([0]), device=dev)
    system = lgp([[c1], [c2]], N=p["lgp_N"], device=dev)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    system.predict(z[:64], m=p["pred_m"])          # builds the dense statistics
    print(_smi(), flush=True)
    window("linked_predict_1000", lambda: system.predict(z, m=p["pred_m"]), out_dir)
    return 0


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != "--linked"]
    out_dir = Path(args[0]) if args else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    if "--linked" in sys.argv[1:]:
        return linked(dev, out_dir)
    params = json.loads((Path(dgp_tpu_torch.__file__).parent / "data"
                         / "vecchia_si_n2000.json").read_text())
    X, Y = chip_smoke.bench_data()
    zp = np.linspace(-1, 1, 20000).reshape(-1, 1)
    nb_seed(123)
    m = dgp(X, Y, layers_from_numpy(params["layers"]), vecchia=True,
            m=chip_smoke.M_TRAIN, device=dev)
    emu = emulator(m.estimate(), N=5, device=dev)      # warm-up
    emu.predict(zp, m=50)
    print(_smi(), flush=True)
    holder = {}
    window("emulator", lambda: holder.update(
        emu=emulator(m.estimate(), N=5, device=dev)), out_dir)
    window("predict20k", lambda: holder["emu"].predict(zp, m=50), out_dir)
    nb_seed(123)
    mt = dgp(X, Y, chip_smoke._bench_layers(), vecchia=True, m=chip_smoke.M_TRAIN,
             device=dev)
    mt.train(N=chip_smoke.TRAIN_WARM, disable=True, chunk_size=16)
    # iterations 49-52: no power-of-2 boundary, so no NN refresh inside
    window("sem4", lambda: mt.train(N=4, disable=True, chunk_size=16), out_dir)

    X2, Y2, _, _ = chip_smoke.twod_data()
    nb_seed(99)

    def k(**kw):
        return dgp_tpu_torch.kernel(length=np.array([1]), name='sexp', **kw)

    md = dgp(X2, [Y2], dgp_tpu_torch.combine(
        [k(), k()], [k(connect=np.arange(2)), k(connect=np.arange(2))],
        [k(connect=np.arange(2)), k(connect=np.arange(2))],
        [k(scale_est=True, connect=np.arange(2))]), device=dev)
    md.train(N=20, disable=True)
    window("dense_sem5", lambda: md.train(N=5, disable=True), out_dir)

    p = json.loads((Path(dgp_tpu_torch.__file__).parent / "data"
                    / "gp_n2000.json").read_text())["protocol"]
    kern = dgp_tpu_torch.kernel(length=np.array([p["length"]]), name=p["kernel"],
                                nugget=p["nugget"], scale_est=p["scale_est"],
                                nugget_est=p["nugget_est"])
    g = dgp_tpu_torch.gp(X, Y, kern, device=dev)
    window("gp_dense_train", g.train, out_dir)
    np.random.seed(p["vecchia_ord_seed"])
    g.to_vecchia(m=p["vecchia_m"])
    window("gp_vecchia_train", g.train, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
