"""Write dgp_tpu_torch/data/design_n2000.json: the `design` phase's protocol
(chip_smoke.py) and the JAX package's figures under it, from which the
phase's quality gates are taken.

The protocol, one sequential-design step of a DGP user on bench.py's n=2000
data (chip_smoke.bench_data: seed 123): the 2-layer Vecchia DGP (sexp,
m=25) at the JAX-trained hyper-parameters of data/vecchia_si_n2000.json,
`nb_seed(seed)`, `dgp(...)`, `emulator(m.estimate(), N=5)`; ALM, MICE and
VIGF (obj=m) at m=50 on 1000 candidates of [-1, 1] (RandomState(7)); the 40
candidates with the highest ALM scores, with `func` plus noise of sd 0.05
(RandomState(11)), added through `update_xy` (the superset path, n=2040);
`train(N=16, chunk_size=16)`, `emulator(m.estimate(), N=5)`; `predict` at
m=50 on bench.py's 1000 test points (RMSE against the noiseless truth) and
`loo` at m=30 on the 2040 training points (RMSE against the observed Y).

Run from the repository root on the CPU (about 10 minutes a seed; dgp_tpu
on JAX):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/make_torch_design_params.py

writes the file after each seed of ``PROTOCOL["seeds"]``; the gates take the
median over them.  ``... make_torch_design_params.py port-cpu SEED`` prints
the port's figures under the same protocol on the CPU.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "dgp_tpu_torch" / "data" / "design_n2000.json"
PARAMS = ROOT / "dgp_tpu_torch" / "data" / "vecchia_si_n2000.json"

PROTOCOL = {
    "n": 2000, "data_seed": 123, "m": 25, "emulator_N": 5, "pred_m": 50,
    "metric_m": 50, "n_cand": 1000, "cand_seed": 7, "n_add": 40, "add_noise_sd": 0.05,
    "add_noise_seed": 11, "train_N": 16, "chunk_size": 16, "n_test": 1000, "loo_m": 30,
    "seeds": [123, 1, 2],
    "hyper_parameters": "data/vecchia_si_n2000.json 'layers' (dgp_tpu, 200 SEM iterations)",
}


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data(p=PROTOCOL):
    """(X, Y, candidates, added-point noise, test points) of the protocol."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(p["n"], 1)
    cand = np.random.RandomState(p["cand_seed"]).uniform(-1, 1, (p["n_cand"], 1))
    noise = p["add_noise_sd"] * np.random.RandomState(p["add_noise_seed"]).randn(p["n_add"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    return X, Y, cand, noise, z


def layers(pkg):
    """The JAX-trained structure of data/vecchia_si_n2000.json as ``pkg``'s
    kernels."""
    spec = json.loads(PARAMS.read_text())["layers"]
    return pkg.combine(*[[pkg.kernel(
        length=np.array(d["length"]), scale=d["scale"], nugget=d["nugget"], name=d["name"],
        nugget_est=d["nugget_est"], scale_est=d["scale_est"],
        connect=None if d.get("connect") is None else np.array(d["connect"]))
        for d in layer] for layer in spec])


def top_alm(alm, k):
    """Indices of the k largest ALM scores (ties by index)."""
    return np.argsort(-alm[:, 0], kind="stable")[:k]


def run(pkg, seed, p=PROTOCOL, **kw):
    """The protocol with package ``pkg`` (dgp_tpu, or dgp_tpu_torch with
    ``device=``) at nb_seed ``seed``: a dict of the figures."""
    X, Y, cand, noise, z = data(p)
    out = {"seed": seed}
    t_all = time.perf_counter()
    pkg.nb_seed(seed)
    m = pkg.dgp(X, Y, layers(pkg), vecchia=True, m=p["m"], **kw)
    emu = pkg.emulator(m.estimate(), N=p["emulator_N"], **kw)
    alm = emu.metric(cand, method="ALM", m=p["metric_m"], score_only=True)
    for meth in ("ALM", "MICE", "VIGF"):
        t0 = time.perf_counter()
        idx, val = emu.metric(cand, method=meth, obj=m, m=p["metric_m"])
        out[meth] = {"index": int(np.ravel(idx)[0]), "value": float(np.ravel(val)[0]),
                     "seconds": time.perf_counter() - t0}
    add = top_alm(alm, p["n_add"])
    X2 = np.vstack([X, cand[add]])
    Y2 = np.vstack([Y, func(cand[add]) + noise])
    t0 = time.perf_counter()
    m.update_xy(X2, Y2)
    out["update_xy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.train(N=p["train_N"], chunk_size=p["chunk_size"], disable=True)
    out["train_s"] = time.perf_counter() - t0
    emu2 = pkg.emulator(m.estimate(), N=p["emulator_N"], **kw)
    mu, _ = emu2.predict(z, m=p["pred_m"])
    out["rmse"] = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    t0 = time.perf_counter()
    lm, _ = emu2.loo(X2, m=p["loo_m"])
    out["loo_s"] = time.perf_counter() - t0
    out["loo_rmse"] = float(np.sqrt(np.mean((lm - Y2) ** 2)))
    out["n_after"] = int(m.n_data)
    out["seconds"] = time.perf_counter() - t_all
    return out


def main():
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["port-cpu"]:
        import dgp_tpu_torch
        for s in sys.argv[2:]:
            print(json.dumps(run(dgp_tpu_torch, int(s), device="cpu")), flush=True)
        return
    import dgp_tpu
    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "dgp_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    by_seed = {}
    for seed in PROTOCOL["seeds"]:
        by_seed[str(seed)] = run(dgp_tpu, seed)
        print(json.dumps(by_seed[str(seed)]), flush=True)
        OUT.write_text(json.dumps({
            "protocol": PROTOCOL,
            "source": "tools/make_torch_design_params.py, dgp_tpu on JAX (CPU), "
                      f"dgp_tpu as of commit {commit}",
            "jax": {"by_seed": by_seed,
                    "rmse_median": statistics.median(r["rmse"] for r in by_seed.values()),
                    "loo_rmse_median": statistics.median(r["loo_rmse"]
                                                         for r in by_seed.values())}},
            indent=1) + "\n")


if __name__ == "__main__":
    main()
