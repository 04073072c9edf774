"""Write dgp_tpu_torch/data/large_n1e5.json: the large_n phase's protocol
and the JAX package's figures under it, from which chip_smoke.py's gates
are taken.

The protocol, on bench.py's n = 1e5 data (`_large_n`: seed 7, x uniform on
[-1, 1], bench.py's function plus noise of sd 0.05): a Vecchia `gp` (m = 25)
with a squared-exponential kernel (length 0.5, nugget 1e-2, scale and
nugget estimated, the default 'ga' prior), the gp_n2000.json protocol at
the new n.  At n >= 50000 the gp searches its neighbours with the IVF
approximate search.  The ordering is np.random.permutation(n) right after
np.random.seed(123).  Then `train()`, `log_likelihood_func()` and
`predict` at m = 50 on 1000 test points of [-1, 1] (RMSE against the
noiseless function).

Recorded: the gp's ordered IVF neighbours (every 100th row, and the
SHA-256 of the whole (n, 26) array as little-endian int64), their recall
against the exact ordered search of the same scaled, ordered input, and
the trained parameters, log-likelihood and RMSE.  The exact search is
dgp_tpu_torch's on the CPU (`vecchia.nn._nn_ordered_impl`, the JAX
package's Gram form and top-k, held equal to it by tests/test_torch_vecchia.py):
the JAX package's own runs XLA's sort-based top-k over 1e5-wide rows and
had not finished after 28 minutes on an 8-core CPU host.

Run from the repository root on the CPU (dgp_tpu on JAX, float64; on an
8-core host the gp's construction, its IVF search, took 3.2 min, the exact
search 2.2 min, `train()` 7.4 min and the prediction 6 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/make_torch_large_params.py

The file is written after each stage.
"""
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "dgp_tpu_torch" / "data" / "large_n1e5.json"

PROTOCOL = {
    "n": 100_000, "data_seed": 7, "kernel": "sexp", "length": 0.5, "nugget": 1e-2,
    "scale_est": True, "nugget_est": True, "n_test": 1000, "vecchia_m": 25,
    "vecchia_ord_seed": 123, "pred_m": 50, "nn_row_stride": 100,
    # bench.py's _large_n and _large_n_predict legs (chip_smoke.py's large_n
    # phase runs them on the card; no JAX figure is made on the CPU)
    "dgp_seed": 7, "dgp_m": 25, "dgp_warm": 32, "dgp_timed": 16, "dgp_chunk": 16,
    "dgp_N": 5, "dgp_pred_m": 25,
}


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data(p=PROTOCOL):
    """(X, Y, z): bench.py's `_large_n` draw and the test points."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(p["n"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    return X, Y, z


def dumps(obj):
    """JSON with one line per list of numbers (the stored rows)."""
    return re.sub(r"\[[-0-9.,e\s]+\]", lambda m: "[" + ",".join(m.group(0)[1:-1].split())
                  .replace(",,", ",") + "]", json.dumps(obj, indent=1)) + "\n"


def nn_sha256(NN):
    """SHA-256 of an NN array as little-endian int64."""
    return hashlib.sha256(np.ascontiguousarray(NN, "<i8").tobytes()).hexdigest()


def recall(approx, exact):
    """Share of the exact sets' entries (-1 padding excluded) that the
    approximate sets hold, row by row."""
    hits = total = 0
    for s in range(0, len(exact), 8192):
        e, a = exact[s:s + 8192], approx[s:s + 8192]
        same = (e[:, :, None] == a[:, None, :]) & (e[:, :, None] >= 0)
        hits += int(same.any(axis=2).sum())
        total += int((e >= 0).sum())
    return hits / total


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    import dgp_tpu
    from dgp_tpu_torch.vecchia import nn as tnn

    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "dgp_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    p = PROTOCOL
    out = {"protocol": p,
           "source": "tools/make_torch_large_params.py, dgp_tpu on JAX (CPU, float64), "
                     f"dgp_tpu as of commit {commit}",
           "jax": {}}
    res = out["jax"]

    def save():
        OUT.write_text(dumps(out))

    X, Y, z = data()
    k = dgp_tpu.kernel(length=np.array([p["length"]]), name=p["kernel"],
                       nugget=p["nugget"], scale_est=p["scale_est"],
                       nugget_est=p["nugget_est"])
    np.random.seed(p["vecchia_ord_seed"])
    t0 = time.perf_counter()
    m = dgp_tpu.gp(X, Y, k, vecchia=True, m=p["vecchia_m"])
    res["construct_s"] = time.perf_counter() - t0
    NN = np.asarray(m.kernel.NNarray)
    res["nn_method"] = m.kernel.nn_method
    res["nn_shape"] = list(NN.shape)
    res["nn_sha256"] = nn_sha256(NN)
    res["nn_rows"] = NN[::p["nn_row_stride"]].tolist()
    res["ord_equals_seeded_permutation"] = bool(np.array_equal(
        m.kernel.ord, np.random.RandomState(p["vecchia_ord_seed"]).permutation(p["n"])))
    save()
    xs = (X / m.kernel.length)[m.kernel.ord]
    t0 = time.perf_counter()
    exact = tnn._nn_ordered_impl(torch.as_tensor(xs), p["vecchia_m"]).numpy()
    res["exact_nn_s"] = time.perf_counter() - t0
    res["recall_vs_exact"] = recall(NN, exact)
    res["rows_equal_exact"] = float(np.mean((NN == exact).all(axis=1)))
    save()
    print(json.dumps({k: v for k, v in res.items() if k != "nn_rows"}), flush=True)
    t0 = time.perf_counter()
    m.train()
    res["train_s"] = time.perf_counter() - t0
    res["scale"] = float(m.kernel.scale[0])
    res["length"] = m.kernel.length.tolist()
    res["nugget"] = float(m.kernel.nugget[0])
    res["log_likelihood"] = float(m.kernel.log_likelihood_func())
    save()
    t0 = time.perf_counter()
    mu, var = m.predict(z, m=p["pred_m"])
    res["predict_s"] = time.perf_counter() - t0
    res["rmse"] = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    save()
    print(json.dumps({k: v for k, v in res.items() if k != "nn_rows"}, indent=1))


if __name__ == "__main__":
    main()
