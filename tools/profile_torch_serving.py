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
kernel), and the top operators by device time and by host time.  With a
directory argument it also writes each window's Chrome trace there.
Usage, from the repository root:

    python3 tools/profile_torch_serving.py [TRACE_DIR]
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
    all_launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    print(json.dumps({"window": name, "wall_s": wall, "device_kernel_s": busy,
                      "device_busy_share": busy / wall, "launches": launches,
                      "cuda_launch_kernel_calls": all_launches,
                      "top_device": _top(ev, "self_device_time_total"),
                      "top_host": _top(ev, "self_cpu_time_total")}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    params = json.loads((Path(dgp_tpu_torch.__file__).parent / "data"
                         / "vecchia_si_n2000.json").read_text())
    X, Y = chip_smoke.bench_data()
    zp = np.linspace(-1, 1, 20000).reshape(-1, 1)
    nb_seed(123)
    m = dgp(X, Y, layers_from_numpy(params["layers"]), vecchia=True,
            m=chip_smoke.M_TRAIN, device=dev)
    emu = emulator(m.estimate(), N=5, device=dev)      # warm-up
    emu.predict(zp, m=50)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
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
