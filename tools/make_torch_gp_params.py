"""Write dgp_tpu_torch/data/gp_n2000.json: the gp phase's protocol and the
JAX package's figures under it, from which chip_smoke.py's gates are taken.

The protocol, on bench.py's n=2000 data (chip_smoke.bench_data: seed 123):
a dense `gp` with a squared-exponential kernel (length 0.5, nugget 1e-2,
scale and nugget estimated, the default 'ga' prior), `train()`, `predict`
on 1000 test points of [-1, 1] (RMSE against the noiseless truth), `loo`,
and ALM / MICE / VIGF on 1000 uniform candidates (seed 7); then the same
model `to_vecchia(m=25)` (ordering from numpy seed 123), `train()`, its
`log_likelihood_func`, and `predict` at m=50 (RMSE).

Run from the repository root on the CPU (about a minute; dgp_tpu on JAX):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/make_torch_gp_params.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "dgp_tpu_torch" / "data" / "gp_n2000.json"

PROTOCOL = {
    "n": 2000, "data_seed": 123, "kernel": "sexp", "length": 0.5, "nugget": 1e-2,
    "scale_est": True, "nugget_est": True, "n_test": 1000, "n_cand": 1000,
    "cand_seed": 7, "vecchia_m": 25, "vecchia_ord_seed": 123, "pred_m": 50,
    "loo_m": 30,
}


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data(p=PROTOCOL):
    """(X, Y, z, candidates) of the protocol."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(p["n"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    cand = np.random.RandomState(p["cand_seed"]).uniform(-1, 1, (p["n_cand"], 1))
    return X, Y, z, cand


def run(pkg, p=PROTOCOL, **kw):
    """The protocol with package ``pkg`` (dgp_tpu or dgp_tpu_torch; ``kw``
    goes to the gp constructor): a dict of the figures."""
    X, Y, z, cand = data(p)
    k = pkg.kernel(length=np.array([p["length"]]), name=p["kernel"], nugget=p["nugget"],
                   scale_est=p["scale_est"], nugget_est=p["nugget_est"])
    m = pkg.gp(X, Y, k, **kw)
    t0 = time.perf_counter()
    m.train()
    out = {"dense_train_s": time.perf_counter() - t0}
    mu, var = m.predict(z)
    out["dense"] = {"rmse": float(np.sqrt(np.mean((mu - func(z)) ** 2))),
                    "scale": float(m.kernel.scale[0]),
                    "length": m.kernel.length.tolist(),
                    "nugget": float(m.kernel.nugget[0])}
    lm, lv = m.loo()
    out["dense"]["loo_rmse"] = float(np.sqrt(np.mean((lm - Y) ** 2)))
    for meth in ("ALM", "MICE", "VIGF"):
        idx, val = m.metric(cand, method=meth)
        out["dense"][meth] = {"index": int(np.ravel(idx)[0]), "value": float(np.ravel(val)[0])}
    np.random.seed(p["vecchia_ord_seed"])
    m.to_vecchia(m=p["vecchia_m"])
    t0 = time.perf_counter()
    m.train()
    out["vecchia_train_s"] = time.perf_counter() - t0
    out["vecchia"] = {"log_likelihood": float(m.kernel.log_likelihood_func()),
                      "scale": float(m.kernel.scale[0]),
                      "length": m.kernel.length.tolist(),
                      "nugget": float(m.kernel.nugget[0])}
    mu, var = m.predict(z, m=p["pred_m"])
    out["vecchia"]["rmse"] = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    return out


def main():
    sys.path.insert(0, str(ROOT))
    import dgp_tpu
    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "dgp_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    res = run(dgp_tpu)
    OUT.write_text(json.dumps({
        "protocol": PROTOCOL,
        "source": "tools/make_torch_gp_params.py, dgp_tpu on JAX (CPU), "
                  f"dgp_tpu as of commit {commit}",
        "jax": res}, indent=1) + "\n")
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
