"""The port's large-n path on one CUDA device, beyond chip_smoke.py's n = 1e5
phase.

``xlarge``: bench.py's `_xlarge_n` protocol (bench.py:231-271) on
dgp_tpu_torch: nb_seed(11), n = 1e6 points of bench.py's function (numpy
seed 11, checked free of duplicates before `check_rep=False`), the 2-layer
Vecchia DGP (m = 25, IVF neighbours), train(N=8, chunk_size=4) as warm-up
(refreshes at 2, 4 and 8), a timed train(N=4, chunk_size=4), then
emulator(N=5) and predict on 1000 points of [-1, 1] at m = 25 (RMSE against
the noiseless function).  Also the IVF build of the layer-1 node's scaled
input alone, and the port's tiled exact search of the same input, timed.
Prints one JSON line with the seconds of each step, SEM it/s, the kernel
launches per timed iteration, torch.cuda.max_memory_allocated and the RMSE.

``profile``: chip_smoke.py's large_n DGP (bench.py's `_large_n`, n = 1e5)
trained for 12 iterations, then one torch.profiler window of iterations
13-16, whose last iteration ends with the NN refresh at 16: the window's
wall and device-busy seconds, the refresh's share of the wall time, the
kernel launches, the hand-written kernels' device ms and the program's
spans (tools/trace_spans_torch.py's window line).

Usage, from the repository root (each mode prints the card's name and power
limit first):

    python3 tools/large_n_torch.py xlarge|profile
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from dgp_tpu_torch import dgp, emulator, nb_seed  # noqa: E402
from dgp_tpu_torch.vecchia import nn as vnn  # noqa: E402

XLARGE = {"n": 1_000_000, "seed": 11, "m": 25, "warm": 8, "timed": 4, "chunk": 4, "N": 5,
          "n_test": 1000}


def xlarge(dev):
    p = XLARGE
    rng = np.random.RandomState(p["seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = chip_smoke.func(X) + 0.05 * rng.randn(p["n"], 1)
    assert len(np.unique(X)) == p["n"], "the draw has duplicates; check_rep=False is wrong"
    out = {"protocol": p}
    xs = torch.as_tensor(X / 0.5, device=dev)
    _, out["ivf_build_s"] = chip_smoke._timed(lambda: vnn.nn_approx(xs, p["m"]))
    _, out["exact_search_s"] = chip_smoke._timed(lambda: vnn._nn_ordered_impl(xs, p["m"]))
    del xs
    torch.cuda.reset_peak_memory_stats()
    refresh_s, restore = chip_smoke.timed_refreshes()
    try:
        nb_seed(p["seed"])
        m, out["construct_s"] = chip_smoke._timed(lambda: dgp(
            X, Y, chip_smoke._bench_layers(), vecchia=True, m=p["m"], check_rep=False,
            device=dev))
        out["nn_method"] = m.nn_method
        _, out["warm_s"] = chip_smoke._timed(
            lambda: m.train(N=p["warm"], disable=True, chunk_size=p["chunk"]))
        before = chip_smoke.launch_counts()
        _, t = chip_smoke._timed(
            lambda: m.train(N=p["timed"], disable=True, chunk_size=p["chunk"]))
    finally:
        restore()
    out["sem_it_per_s"] = p["timed"] / t
    out["launches_per_iteration"] = {k: (v - before[k]) / p["timed"]
                                     for k, v in chip_smoke.launch_counts().items()}
    out["nn_refresh_s"] = refresh_s
    out["max_memory_allocated_gb_training"] = torch.cuda.max_memory_allocated() / 1e9
    emu, out["emulator_build_s"] = chip_smoke._timed(
        lambda: emulator(m.estimate(), N=p["N"], device=dev))
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    (mu, var), out["predict_1000_s"] = chip_smoke._timed(lambda: emu.predict(z, m=p["m"]))
    out["rmse"] = float(np.sqrt(np.mean((mu - chip_smoke.func(z)) ** 2)))
    out["finite"] = bool(np.isfinite(mu).all() and np.isfinite(var).all())
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["trained"] = [{"scale": float(nd.scale[0]), "length": nd.length.tolist(),
                       "nugget": float(nd.nugget[0])} for layer in m.all_layer
                      for nd in layer]
    print(json.dumps({"mode": "xlarge", **out}), flush=True)
    return 0


def profile(dev):
    import trace_spans_torch
    p = chip_smoke._data_json("large_n1e5.json")["protocol"]
    X, Y = chip_smoke.large_data(p)
    nb_seed(p["dgp_seed"])
    m = dgp(X, Y, chip_smoke._bench_layers(), vecchia=True, m=p["dgp_m"], check_rep=False,
            device=dev)
    m.train(N=12, disable=True, chunk_size=p["dgp_chunk"])
    refresh_s, restore = chip_smoke.timed_refreshes()
    try:
        win = trace_spans_torch.window("large_n_sem13_16", lambda: m.train(
            N=4, disable=True, chunk_size=p["dgp_chunk"]))
    finally:
        restore()
    print(json.dumps({"mode": "profile", "refresh_s": refresh_s,
                      "refresh_share_of_window": sum(refresh_s) / win["wall_s"]}), flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("xlarge", "profile"):
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    return xlarge(dev) if mode == "xlarge" else profile(dev)


if __name__ == "__main__":
    sys.exit(main())
