"""One-card cost of dgp_tpu_torch's SEM training and predictions, for
comparing two trees of the repository on the same card.

    python tools/split_cost.py [--root DIR] [--lgp-points N] [--sem-only --reps K]
                               [--model gate|large|large25|wide] [--profile]

imports `dgp_tpu_torch` from ``DIR`` (default: this checkout) and times, on
cuda:0, the paths that the split over a mesh runs through:

- ``sem_n2000``: `dgp.train(N=16)` of the main path's model (n = 2000,
  m = 25, `chip_smoke.py`'s data and structure) after 2 iterations of
  warm-up, and, where the tree splits SEM, `ptrain(N=16)` on a mesh of two
  shares of the one card, each timed ``--reps`` times (with
  ``--sem-only``, nothing else).  With ``--model gate`` the model is
  instead `chip_smoke.py`'s `gate` phase's at m = 40 (blocks of 41 rows,
  bench.py's starting hyper-parameters, `train(N=16, chunk_size=16)` after
  16 of warm-up, no ptrain); with ``--model large`` it is `large_n`'s
  DGP (bench.py's n = 1e5 draw, its seed, warm-up and chunk) at m = 40,
  and with ``--model large25`` the same DGP at bench.py's m = 25, as
  `large_n` runs it; each of these models times SEM alone.  With
  ``--profile``, 4 more iterations of `train` then run in one window of
  `tools/trace_spans_torch.window` (wall seconds, the device's busy share,
  launches and device milliseconds of each hand-written kernel, the
  program's spans), reported also per iteration;
- ``gp_wide`` (``--model wide``, and nothing else): the `gate` phase's
  12-input function (`chip_smoke.gate_gp_data`'s law and seed) drawn at
  n = 1e5, a Vecchia gp with 12 lengthscales at m = 25 (the IVF search,
  as from n >= 50000), `gp.train()` timed ``--reps`` times after one
  warm-up `train()`, each starting where the last ended; with
  ``--profile`` one more `train()` in one profiler window;
- ``emulator``: the main path's emulator (N = 5) predicting 20000 points
  at m = 50;
- ``gp_dense`` / ``gp_vecchia``: the `gp` phase's gp predicting 20000
  points, dense and then Vecchia at its pred_m;
- ``gp_1e5``: `large_n`'s Vecchia gp at n = 1e5 (the IVF search)
  predicting 20000 points;
- ``lgp``: the `linked` phase's system (its first seed) predicting
  ``--lgp-points`` points.

Every prediction is timed on its second call, the card synchronised on
both sides.  Prints one JSON object with the card's name and power limit.
The data and protocols are this checkout's (`chip_smoke.py`,
`dgp_tpu_torch/data`), whatever ``--root`` is.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
#: points of the ``--model wide`` gp
WIDE_N = 100_000


def _load(name, path):
    """Imports the module at ``path`` as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _profile(m, iters, kw):
    """``iters`` more SEM iterations of ``m`` in one window of
    `trace_spans_torch.window`, with each hand-written kernel's device ms
    and launches an iteration."""
    tst = _load("trace_spans_torch", HERE / "tools" / "trace_spans_torch.py")
    w = tst.window(f"sem{iters}", lambda: m.train(N=iters, disable=True, **kw))
    w["per_iteration"] = {k: {"device_ms": w["kernel_device_ms"][k] / iters,
                              "launches": w["launches"][k] / iters} for k in w["launches"]}
    return w


def _wide(cs, dev, reps, profiled):
    """`gp.train()` of a Vecchia gp with 12 lengthscales at n = 1e5 on the
    `gate` phase's 12-input law: seconds per call after one warm-up, and
    the hand-written kernels' launches per call; with ``profiled`` one more
    call in a profiler window."""
    from dgp_tpu_torch import gp, kernel
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    X, Y = cs.gate_gp_data(WIDE_N)
    np.random.seed(cs.GATE_GP_SEED)
    t0 = time.perf_counter()
    g = gp(X, Y, kernel(length=np.full(cs.GATE_GP_D, 0.5), name="sexp", scale_est=True,
                        nugget_est=True), vecchia=True, m=cs.M_TRAIN, device=dev)
    out = {"n": len(X), "d": X.shape[1], "m": cs.M_TRAIN, "nn_method": g.kernel.nn_method,
           "build_s": time.perf_counter() - t0,
           "warmup_s": cs._timed(g.train)[1]}
    ts, launches = [], []
    for _ in range(reps):
        cv.reset_launch_counts()
        ts.append(cs._timed(g.train)[1])
        launches.append(cs.launch_counts())
    out.update(train_s=ts, launches=launches, length=g.kernel.length.tolist())
    if profiled:
        tst = _load("trace_spans_torch", HERE / "tools" / "trace_spans_torch.py")
        out["profile"] = tst.window("gp_wide_train", g.train)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--lgp-points", type=int, default=2500)
    ap.add_argument("--sem-only", action="store_true")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--model", choices=("main", "gate", "large", "large25", "wide"),
                    default="main")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import dgp_tpu_torch
    assert Path(dgp_tpu_torch.__file__).resolve().is_relative_to(root)
    from dgp_tpu_torch import (container, dgp, emulator, gp, kernel, layers_from_numpy,
                               lgp, nb_seed)
    from dgp_tpu_torch.parallel import mesh as pmesh
    cs = _load("chip_smoke", HERE / "chip_smoke.py")
    dev = torch.device("cuda", 0)
    out = {"root": str(root), "nvidia_smi": cs.nvidia_smi()}
    t_all = time.perf_counter()
    if args.model == "wide":
        out["gp_wide"] = _wide(cs, dev, args.reps, args.profile)
        print(json.dumps(out), flush=True)
        return

    def timed(fn):
        fn()
        return cs._timed(fn)[1]

    # SEM at n = 2000 (n = 1e5 for the large model)
    X, Y = cs.bench_data()
    layers = cs._params_json()["layers"]
    lp = cs._data_json("large_n1e5.json")["protocol"]
    large = args.model in ("large", "large25")
    if large:
        X, Y = cs.large_data(lp)
    m_sem = {"main": cs.M_TRAIN, "large25": lp["dgp_m"]}.get(args.model, cs.GATE_M)

    def build():
        if large:
            nb_seed(lp["dgp_seed"])
            return dgp(X, Y, cs._bench_layers(), vecchia=True, m=m_sem, check_rep=False,
                       device=dev)
        nb_seed(123)
        if args.model == "gate":
            return dgp(X, Y, cs._bench_layers(), vecchia=True, m=cs.GATE_M, device=dev)
        return dgp(X, Y, layers_from_numpy(layers), vecchia=True, m=cs.M_TRAIN, device=dev)
    kw = {"main": {}, "gate": {"chunk_size": 16}}.get(args.model,
                                                       {"chunk_size": lp["dgp_chunk"]})
    warmup = {"main": 2, "gate": 16}.get(args.model, lp["dgp_warm"])
    sem = {"model": args.model, "n": len(X), "m": m_sem, "warmup": warmup}
    hows = ["train"] + (["ptrain"] if hasattr(pmesh, "Split") and args.model == "main"
                        else [])
    real_mesh = pmesh.model_mesh
    pmesh.model_mesh = lambda device: (dev, dev)
    try:
        for how in hows:
            m = build()
            getattr(m, how)(N=warmup, disable=True, **kw)
            ts = [cs._timed(lambda: getattr(m, how)(N=16, disable=True, **kw))[1]
                  for _ in range(args.reps)]
            sem[how] = {"seconds_16": ts, "sem_it_per_s": [16 / t for t in ts]}
            if how == "train" and args.profile:
                sem["profile"] = _profile(m, 4, kw)
    finally:
        pmesh.model_mesh = real_mesh
    out["sem_n1e5" if large else "sem_n2000"] = sem
    if args.sem_only or args.model != "main":
        print(json.dumps(out), flush=True)
        return
    zp = np.linspace(-1, 1, cs.N_PRED).reshape(-1, 1)
    emu = emulator(m.estimate(), N=5, device=dev)
    out["emulator"] = {"predict_20000_s": timed(lambda: emu.predict(zp, m=50))}

    # the gp phase's gp, dense then Vecchia
    p = cs._data_json("gp_n2000.json")["protocol"]
    nb_seed(123)
    g = gp(X, Y, kernel(length=np.array([p["length"]]), name=p["kernel"], nugget=p["nugget"],
                        scale_est=p["scale_est"], nugget_est=p["nugget_est"]), device=dev)
    g.train()
    out["gp_dense"] = {"predict_20000_s": timed(lambda: g.predict(zp))}
    np.random.seed(p["vecchia_ord_seed"])
    g.to_vecchia(m=p["vecchia_m"])
    g.train()
    out["gp_vecchia"] = {"predict_20000_s": timed(lambda: g.predict(zp, m=p["pred_m"]))}

    # large_n's gp at n = 1e5
    lp = cs._data_json("large_n1e5.json")["protocol"]
    XL, YL = cs.large_data(lp)
    np.random.seed(lp["vecchia_ord_seed"])
    gl = gp(XL, YL, kernel(length=np.array([lp["length"]]), name=lp["kernel"],
                           nugget=lp["nugget"], scale_est=lp["scale_est"],
                           nugget_est=lp["nugget_est"]),
            vecchia=True, m=lp["vecchia_m"], device=dev)
    gl.train()
    out["gp_1e5"] = {"nn_method": gl.kernel.nn_method,
                     "predict_20000_s": timed(lambda: gl.predict(zp, m=lp["pred_m"]))}
    del gl, XL, YL

    # the linked phase's system, its first seed
    lref = cs._data_json("linked_n2000.json")
    q = lref["protocol"]
    X1, Y1, X2, Y2 = cs.linked_data(q)
    np.random.seed(q["gp_ord_seed"])
    g1 = gp(X1, Y1, kernel(length=np.array([q["gp_length"]]), name=q["gp_kernel"],
                           scale_est=True, nugget_est=True), vecchia=True, m=q["m"],
            device=dev)
    g1.train()
    seed = q["lgp_seeds"][0]
    nb_seed(seed)
    np.random.seed(seed)
    m2 = dgp(X2, Y2, cs.linked_layers(lref), vecchia=True, m=q["m"], device=dev)
    system = lgp([[container(g1.export(), local_input_idx=np.array([0]), device=dev)],
                  [container(m2.estimate(), local_input_idx=np.array([0]), device=dev)]],
                 N=q["lgp_N"], device=dev)
    zl = np.linspace(-1, 1, args.lgp_points).reshape(-1, 1)
    out["lgp"] = {"points": args.lgp_points,
                  "predict_s": timed(lambda: system.predict(zl, m=q["pred_m"]))}
    out["seconds"] = time.perf_counter() - t_all
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
