#!/usr/bin/env python3
"""Smoke run of dgp_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Phases, each printing its results as one JSON line:

  device   require CUDA; print the card's name and power limit as
           `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
           gives them.
  build    build the hand-written kernels from dgp_tpu_torch/csrc with nvcc
           for sm_90a; print the build seconds and ptxas's spill counts.
  kernels  run each kernel and its plain PyTorch version on the card at the
           shapes of the main path (K3 at (26, 1, 2000); K2 at (26, 2, 2000)
           with K=9, dl=1 and dl=d), for sexp and Matern-2.5, float64 and
           float32, with sentinel lanes; check them against each other and
           time both (median of CUDA-event timings).
  main     the port's serving path at the configuration of bench.py: a
           2-layer Vecchia DGP, n=2000, m=25, hyper-parameters from
           dgp_tpu_torch/data/vecchia_si_n2000.json; dgp(...), then
           emulator(m.estimate(), N=5), predict on 1000 points at m=50 and
           then on 20000 points.  Fails unless both kernels were launched
           by this path and the RMSE against the noiseless truth is finite
           and at most twice the JAX package's figure in the JSON.

Then it prints the kernel summary line and, last, the device line.  Any
failed phase exits non-zero.  Usage, from the repository root:

    python3 chip_smoke.py
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_TRAIN = 2000
M_TRAIN = 25
# float64, per value: |kernel - plain| <= ATOL + RTOL |plain|.  Checked on
# well-conditioned blocks at the main path's shapes (nugget 0.1, so every
# block's condition number is below ~300).
RTOL64, ATOL64 = 1e-9, 1e-12
# float64 on the main path's own blocks (nugget 1e-4): condition numbers
# reach ~1e5, so two correct Cholesky orders (the kernel's column order and
# the library's blocked one) differ by ~cond * eps ~ 1e-11 relative to the
# largest value, and near-zero values cannot meet a per-value bound.  Here
# the bound is normwise: max |kernel - plain| <= RTOL64 * max |plain|.
NUGGET_WELL, NUGGET_BENCH = 1e-1, 1e-4
# float32, K2: relative error of the summed log-likelihood against the
# float64 plain version (the repo's own float32 bound, tests/test_pallas.py)
REL_LL32 = 5e-3
# float32, per-point values and K3's weights: the blocks at this n are
# ill-conditioned (neighbours 1e-3 apart, diagonal 1 + 1e-4 + 3e-5), so
# float32 errors of order 1e-2 relative are inherent to any factorisation.
# The kernel must be no less accurate than the plain PyTorch version in
# float32: max |kernel32 - plain64| <= F32_FACTOR * max |plain32 - plain64|
# + F32_FLOOR * max |plain64|.  The factor allows for the two Cholesky
# orders rounding differently on the worst-conditioned block.
F32_FACTOR, F32_FLOOR = 4.0, 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def bench_data():
    rng = np.random.RandomState(123)
    X = rng.rand(N_TRAIN, 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(N_TRAIN, 1)
    return X, Y


def cuda_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})


def phase_build():
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    t0 = time.perf_counter()
    cv.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cv.build_info["seconds"],
          "ptxas": cv.build_info["ptxas"]})


def _slice_inputs(dtype, device, nugget):
    """K3 and K2 inputs at the main path's shapes, built from the bench
    data the way vecchia.core.cond_weights and
    CompiledDGP._build_angle_plan build them (bench.py's starting
    lengthscale, 0.5; ``nugget`` sets the conditioning)."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore
    from dgp_tpu_torch.vecchia import nn as vnn

    X, Y = bench_data()
    rs = np.random.RandomState(0)
    jit = vcore._f32_jitter(dtype)
    length = 0.5

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # K3: layer-1 node, input X
    ordv = rs.permutation(N_TRAIN)
    NN = torch.as_tensor(vnn.nn(X[ordv] / length, M_TRAIN), device=device)
    Xg, _, diag = cv.gather_scale_t(t(X[ordv]), t(np.zeros(N_TRAIN)), NN,
                                    t([length]), nugget, t(np.ones(N_TRAIN)), jit)
    k3 = (Xg, diag)

    # K2: layer-2 node, input (latent f, global x); candidates cos*f + sin*nu
    f = X[:, 0]                       # the initial latent forwards X
    nu = 0.5 * np.sin(3 * X[:, 0] + 1.0)
    WG = np.column_stack([f, X[:, 0]])
    ordv = rs.permutation(N_TRAIN)
    NN = vnn.nn(WG[ordv] / length, M_TRAIN)
    rev = np.flip(NN, axis=1)
    validT = (rev >= 0).T
    safeT = np.where(validT, rev.T, 0)
    m1 = safeT.shape[0]
    sent = cv.sentinels(N_TRAIN, m1, dtype, device)
    vt = torch.as_tensor(validT, device=device)

    def view(col):
        g = np.where(validT, (col[ordv] / length)[safeT], 0.0)
        return np.stack([g, np.zeros_like(g)], axis=1)        # (m1, 2, n)

    A, B = t(view(f)), t(view(nu))
    Cg = np.where(validT, (X[:, 0][ordv] / length)[safeT], 0.0)
    C = t(np.stack([np.zeros_like(Cg), Cg], axis=1))
    C = torch.where(vt[:, None, :], C, sent[:, None, :])
    yg = t(np.where(validT, Y[:, 0][ordv][safeT], 0.0))
    diag2 = torch.where(vt, torch.full_like(yg, 1.0 + nugget + jit),
                        torch.ones_like(yg))
    ang = np.concatenate([[0.0], rs.uniform(0, 2 * np.pi, 8)])
    cosv, sinv = t(np.cos(ang)), t(np.sin(ang))
    k2 = (A, B, C, yg, diag2, cosv, sinv)
    # dl = d: both dims candidate-dependent (C holds the sentinels only)
    g2 = np.where(validT, (np.cos(2 * X[:, 0])[ordv] / length)[safeT], 0.0)
    A2 = A.clone()
    A2[:, 1] = t(g2)
    B2 = B.clone()
    B2[:, 1] = t(np.where(validT, (np.sin(4 * X[:, 0])[ordv] / length)[safeT], 0.0))
    C2 = torch.where(vt[:, None, :], torch.zeros_like(C), sent[:, None, :])
    k2_full = (A2, B2, C2, yg, diag2, cosv, sinv)
    return k3, k2, k2_full


def _err64(out, ref, per_value):
    worst, ok, detail = 0.0, True, []
    for a, b in zip(out, ref):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        if per_value:
            bad = int((d > ATOL64 + RTOL64 * b.abs()).sum())
        else:
            bad = int(float(d.max()) > RTOL64 * float(b.abs().max()))
        ok &= bad == 0 and bool(a.isfinite().all())
        detail.append({"max_abs_err": float(d.max()), "max_abs": float(b.abs().max()),
                       "violations": bad})
    return ok, worst, detail


def _err32(out32, ref32, ref64):
    worst, ok, detail = 0.0, True, []
    for a, p, r in zip(out32, ref32, ref64):
        e_k = float((a.double() - r).abs().max())
        e_p = float((p.double() - r).abs().max())
        bound = F32_FACTOR * e_p + F32_FLOOR * float(r.abs().max())
        ok &= bool(a.isfinite().all()) and e_k <= bound
        worst = max(worst, e_k)
        detail.append({"kernel_err": e_k, "plain_err": e_p, "bound": bound})
    return ok, worst, detail


def _compare(kname, kern, plain, well64, in64, in32, kw):
    """Kernel against plain version.  float64: per value on well-conditioned
    blocks, normwise on the main path's blocks.  float32: against the
    float64 plain version on the same (upcast) inputs, so that only the
    kernel's float32 arithmetic is measured."""
    import torch
    rows = []
    for label, ins, per_value in (("well", well64, True), ("bench", in64, False)):
        out = kern(*ins, **kw)
        ref = plain(*ins, **kw)
        torch.cuda.synchronize()
        ok, err, det = _err64(out, ref, per_value)
        rows.append({"kernel": kname, "dtype": "float64", "blocks": label,
                     "per_value": per_value, "shape": list(ins[0].shape),
                     "ok": ok, "max_abs_err": err, "detail": det})
    out32 = kern(*in32, **kw)
    ref32 = plain(*in32, **kw)
    ref32_64 = plain(*[a.double() for a in in32], **kw)
    ok32, err32, det = _err32(out32, ref32, ref32_64)
    row32 = {"kernel": kname, "dtype": "float32", "blocks": "bench", "ok": ok32,
             "max_abs_err_vs_f64": err32, "detail": det}
    if kname == "block_loglik_multi_t":
        ll64 = -0.5 * (ref32_64[0] + ref32_64[1]).sum(dim=1)
        ll32 = -0.5 * (out32[0].double() + out32[1].double()).sum(dim=1)
        rel = float(((ll32 - ll64).abs() / ll64.abs()).max())
        row32.update(loglik_rel_err=rel, ok=ok32 and rel < REL_LL32)
    return rows + [row32]


def phase_kernels(dev):
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    results = {"cond_weights_t": {"max_abs_err": 0.0},
               "block_loglik_multi_t": {"max_abs_err": 0.0}}
    failures = []
    well64 = _slice_inputs(torch.float64, dev, NUGGET_WELL)
    in64 = _slice_inputs(torch.float64, dev, NUGGET_BENCH)
    in32 = _slice_inputs(torch.float32, dev, NUGGET_BENCH)
    cases = (("cond_weights_t", 0, {}, "K3"),
             ("block_loglik_multi_t", 1, {"dl": 1}, "dl=1"),
             ("block_loglik_multi_t", 2, {"dl": 2}, "dl=d"))
    for name in ("sexp", "matern2.5"):
        for kname, i, kw, label in cases:
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            rows = _compare(kname, kern, plain, well64[i], in64[i], in32[i],
                            dict(kw, name=name))
            results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                                rows[0]["max_abs_err"],
                                                rows[1]["max_abs_err"])
            for r in rows:
                emit({"phase": "kernels", "name": name, "case": label, **r})
                if not r["ok"]:
                    failures.append(r)
    # times at the main path's configuration (sexp, K=9, dl=1)
    timing = {}
    for dt, ins in (("float64", in64), ("float32", in32)):
        for kname, i, kw in (("cond_weights_t", 0, {}),
                             ("block_loglik_multi_t", 1, {"dl": 1})):
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            kw = dict(kw, name="sexp")
            timing[(dt, kname)] = (cuda_ms(lambda: kern(*ins[i], **kw)),
                                   cuda_ms(lambda: plain(*ins[i], **kw)))
    for kname in results:
        results[kname]["ms"], results[kname]["plain_ms"] = timing[("float64", kname)]
    emit({"phase": "kernels", "timing_ms": {
        f"{dt}/{k}": {"kernel": a, "plain": b} for (dt, k), (a, b) in timing.items()}})
    if failures:
        raise SystemExit(f"kernel comparisons failed: {len(failures)}")
    return results


def phase_main(dev):
    import torch
    from pathlib import Path
    import dgp_tpu_torch
    from dgp_tpu_torch import dgp, emulator, layers_from_numpy, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    params = json.loads((Path(dgp_tpu_torch.__file__).parent / "data"
                         / "vecchia_si_n2000.json").read_text())
    X, Y = bench_data()
    nb_seed(123)
    cv.reset_launch_counts()
    t0 = time.perf_counter()
    m = dgp(X, Y, layers_from_numpy(params["layers"]), vecchia=True, m=M_TRAIN,
            device=dev)
    torch.cuda.synchronize()
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    emu = emulator(m.estimate(), N=5, device=dev)
    torch.cuda.synchronize()
    t_emu = time.perf_counter() - t0
    z = np.linspace(-1, 1, 1000).reshape(-1, 1)
    mu, var = emu.predict(z, m=50)
    rmse = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    zp = np.linspace(-1, 1, 20000).reshape(-1, 1)
    t0 = time.perf_counter()
    mu_p, var_p = emu.predict(zp, m=50)
    t_pred = time.perf_counter() - t0
    launches = {"cond_weights_t": cv.cond_weights_t.launches,
                "block_loglik_multi_t": cv.block_loglik_multi_t.launches}
    gate = 2.0 * params["emulator"]["rmse_gate_ref"]
    checks = {
        "launches": all(v > 0 for v in launches.values()),
        "shapes": mu.shape == (1000, 1) and var.shape == (1000, 1)
        and mu_p.shape == (20000, 1) and var_p.shape == (20000, 1),
        "finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                       and np.isfinite(mu_p).all() and np.isfinite(var_p).all()),
        "variance_positive": bool((var > 0).all() and (var_p > 0).all()),
        "rmse": bool(np.isfinite(rmse) and rmse <= gate),
    }
    emit({"phase": "main", "n": N_TRAIN, "m": M_TRAIN, "N": 5, "dtype": "float64",
          "dgp_construct_s": t_dgp, "emulator_build_s": t_emu, "rmse": rmse,
          "rmse_gate": gate, "rmse_jax_ref": params["emulator"]["rmse_gate_ref"],
          "predict_20000_s": t_pred, "predict_pts_per_s": len(zp) / t_pred,
          "launches": launches, "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"main path checks failed: {checks}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dgp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    results = phase_kernels(dev)
    launches = phase_main(dev)
    sources = {"cond_weights_t": ("dgp_tpu_torch/csrc/cond_weights.cu",
                                  "dgp_tpu/ops/pallas_vecchia.py:202"),
               "block_loglik_multi_t": ("dgp_tpu_torch/csrc/block_loglik_multi.cu",
                                        "dgp_tpu/ops/pallas_vecchia.py:326")}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]} for k in sources]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
