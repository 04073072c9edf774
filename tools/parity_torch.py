#!/usr/bin/env python3
"""Quality parity of dgp_tpu_torch (the PyTorch/CUDA port) on the card.

The rows of `tools/parity.py` -- the reference demo notebooks'
configurations -- run against `dgp_tpu_torch` on the current CUDA device
under the same protocol (data from `tools/parity_data.py`, seeds, SEM
iterations, imputations, m), and each is held to its gate there
(`parity.GATES`, `parity.apply_gate`, unchanged) with the anchors of
`REF_ANCHORS.json` (dgpsi on the same draw) attached as
`reference_on_same_draw`, exactly as `parity.py`'s `main` attaches them.

  step, 2d, multioutput, poisson, zip, linked   one SEM seed (nb_seed 99)
  dgp_poisson, negbin   SEM seeds 99, 1 and 2; the row's figures are the
                        medians over the seeds (their one-seed figures
                        spread wider than the gates: ROADMAP Queue 3)
  vecchia, vecchia_f32  n = 5000, m = 25, train(N=100), predict at m = 200,
                        in float64 and in float32 (parity.py ran float32 on
                        the TPU); both under the `vecchia` gate
  wine_reduced, wine    the wine data and scikit-learn's GPC figures from
                        dgp_tpu_torch/data/parity_wine.json (written by
                        tools/make_torch_parity_data.py: the card's machine
                        has no scikit-learn); `log_loss` and
                        `accuracy_score` are numpy copies of scikit-learn
                        1.9's
  motorcycle            waits for its data files, which are not in the
                        repository (parity_data.MC_IN, MC_OUT)

Every run of a row at one seed is a spawned worker process, side by side
with the others on the one card (the rows are small dense models, bound by
the host), the longest first.  Each row of PARITY_torch.json (at the
repository root; rows not run keep their last record) holds its figures,
its gate result, its wall seconds (per seed), dtype, the kernel launches
and large-block route calls of its runs, and the card's name and power
limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
gives them.

Usage, from the repository root, on a machine with a card:

    python3 tools/parity_torch.py [row ...] [--workers N] [--out FILE]
                                  [--seeds S1,S2,...] [--device cpu]

``--out``: the record to merge into and write (default PARITY_torch.json);
``--seeds``: run every named row at these SEM seeds instead of its
protocol's (a seed spread; write it to another file); ``--device cpu``:
run on the CPU instead of the card.
"""
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)
sys.path.insert(0, _HERE)

import parity  # noqa: E402  (numpy only at import: GATES, apply_gate)
import parity_data as pdata  # noqa: E402

OUT = os.path.join(_ROOT, "PARITY_torch.json")
ANCHORS = os.path.join(_ROOT, "REF_ANCHORS.json")
WINE = os.path.join(_ROOT, "dgp_tpu_torch", "data", "parity_wine.json")

#: SEM seeds (nb_seed) of each row; a row with several reports medians
SEEDS = {"dgp_poisson": (99, 1, 2), "negbin": (99, 1, 2)}
#: the parity.py gate (and anchor) of a row
GATE_OF = {"vecchia_f32": "vecchia"}
DTYPES = {"vecchia_f32": "float32"}
#: the rows in the order their workers start: the longest first
ORDER = ("wine", "dgp_poisson", "negbin", "2d", "vecchia", "vecchia_f32", "zip",
         "step", "linked", "multioutput", "poisson", "wine_reduced")
WAITING = {"motorcycle": "waits for mc_input.txt and mc_output.txt "
                         "(tools/parity_data.py:14-15), not in the repository"}


# ----------------------------------------------------------------------
# scikit-learn 1.9's metrics in numpy
# ----------------------------------------------------------------------
def log_loss(y_true, y_proba):
    """sklearn.metrics.log_loss (1.9) for labels and (n, K) class
    probabilities, the classes taken from y_true in sorted order: the
    probabilities clipped to [eps, 1 - eps] of their dtype, the mean of
    -log p of each true class."""
    y_proba = np.asarray(y_proba)
    if y_proba.dtype not in (np.float32, np.float64):
        y_proba = y_proba.astype(np.float64)
    if y_proba.ndim == 1:
        y_proba = y_proba[:, None]
    if y_proba.shape[1] == 1:
        y_proba = np.concatenate([1 - y_proba, y_proba], axis=1)
    classes = np.unique(y_true)
    if len(classes) != y_proba.shape[1]:
        raise ValueError(f"y_true and y_proba contain different number of classes: "
                         f"{len(classes)} vs {y_proba.shape[1]}")
    onehot = (np.asarray(y_true)[:, None] == classes[None, :]).astype(y_proba.dtype)
    eps = np.finfo(y_proba.dtype).eps
    p = np.clip(y_proba, eps, 1 - eps)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = onehot * np.log(p)
    terms = np.where(onehot == 0.0, np.asarray(0.0, terms.dtype), terms)
    return float(np.average(-np.sum(terms, axis=1)))


def accuracy_score(y_true, y_pred):
    """sklearn.metrics.accuracy_score (1.9): the share of equal labels."""
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def _wine():
    with open(WINE) as fh:
        w = json.load(fh)
    return (np.asarray(w["Xtr"]), np.asarray(w["Xte"]), np.asarray(w["ytr"]),
            np.asarray(w["yte"]), w)


def _oracle_poisson(z, test_Yz, f):
    from scipy.special import gammaln
    lam = np.array([f(x) for x in z]).reshape(-1, 1)
    return float(np.mean(-(test_Yz * np.log(lam) - lam - gammaln(test_Yz + 1.0))))


# ----------------------------------------------------------------------
# the rows: copies of tools/parity.py's against dgp_tpu_torch on the card
# ----------------------------------------------------------------------
def step(seed, dev):
    """parity.py:52-69: 3-layer sexp DGP, n=10, exact step."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, nb_seed
    nb_seed(seed)
    X, Y, z, truth = pdata.step_data()
    all_layer = combine([kernel(length=np.array([1.]), name='sexp')],
                        [kernel(length=np.array([1.]), name='sexp')],
                        [kernel(length=np.array([1.]), name='sexp', scale_est=True)])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), device=dev)
    mu, var = emu.predict(z, method='mean_var')
    rmse = float(np.sqrt(np.mean((mu - truth) ** 2)))
    rmse_train = float(np.sqrt(np.mean((emu.predict(X, method='mean_var')[0] - Y) ** 2)))
    return {"rmse_vs_truth": rmse, "rmse_at_train_pts": rmse_train}


def twod(seed, dev):
    """parity.py:72-87: 4-layer sexp DGP, n=24, 2-D function."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, nb_seed
    nb_seed(seed)
    X, Y, z, truth = pdata.twod_data()

    def k(**kw):
        return kernel(length=np.array([1]), name='sexp', **kw)
    all_layer = combine([k(), k()],
                        [k(connect=np.arange(2)), k(connect=np.arange(2))],
                        [k(connect=np.arange(2)), k(connect=np.arange(2))],
                        [k(scale_est=True, connect=np.arange(2))])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), N=50, device=dev)
    mu, var = emu.predict(z, method='mean_var')
    return {"rmse_vs_truth_diag": float(np.sqrt(np.mean((mu.flatten()
                                                         - truth.flatten()) ** 2)))}


def poisson(seed, dev):
    """parity.py:109-127: GP + Poisson, n=90."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, Poisson, nb_seed
    nb_seed(seed)
    X, Y, z, test_Yz, f = pdata.poisson_data()
    layer1 = [kernel(length=np.array([0.5]), name='matern2.5', scale_est=True)]
    m = dgp(X, [Y], combine(layer1, [Poisson()]), device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), device=dev)
    nll = float(np.asarray(emu.nllik(z, test_Yz)[0]))
    return {"test_nllik": nll, "oracle_nllik": _oracle_poisson(z, test_Yz, f),
            "reference_own_draw_nllik": 1.8274}


def dgp_poisson(seed, dev):
    """parity.py:130-157: 2-layer DGP + Poisson, train(N=1000), N=50."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, Poisson, nb_seed
    nb_seed(seed)
    X, Y, z, test_Yz, f = pdata.poisson_data()
    all_layer = combine(
        [kernel(length=np.array([0.5]), name='matern2.5')],
        [kernel(length=np.array([0.1]), name='matern2.5', scale_est=True,
                connect=np.arange(1))],
        [Poisson()])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=1000, disable=True)
    emu = emulator(m.estimate(), N=50, device=dev)
    nll = float(np.asarray(emu.nllik(z, test_Yz)[0]))
    return {"test_nllik": nll, "oracle_nllik": _oracle_poisson(z, test_Yz, f),
            "reference_own_draw_nllik": 1.7790}


def negbin(seed, dev):
    """parity.py:160-185: 2-layer DGP (mean + dispersion nodes) + NegBin,
    n=180, train(N=500), N=50."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, NegBin, nb_seed
    nb_seed(seed)
    X, Y, Xt, Yt, test_Yt = pdata.negbin_data()
    all_layer = combine(
        [kernel(length=np.array([0.5]), name='matern2.5')],
        [kernel(length=np.array([0.02]), name='matern2.5', scale_est=True,
                connect=np.arange(1)),
         kernel(length=np.array([0.02]), name='matern2.5', scale_est=True,
                connect=np.arange(1))],
        [NegBin()])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), N=50, device=dev)
    mu, var = emu.predict(Xt, method='mean_var')
    rmse_mean = float(np.sqrt(np.mean((np.asarray(mu).flatten() - Yt.flatten()) ** 2)))
    nll = float(np.asarray(emu.nllik(Xt, test_Yt)[0]))
    return {"rmse_mean_vs_truth": rmse_mean, "test_nllik": nll}


def zip_demo(seed, dev):
    """parity.py:188-210: 2-layer DGP (rate + inflation nodes) + ZIP."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, ZIP, nb_seed
    nb_seed(seed)
    X, Y, Xt, Yt_mean, test_Yt = pdata.zip_data()
    all_layer = combine(
        [kernel(length=np.array([0.5]), name='matern2.5')],
        [kernel(length=np.array([0.2]), name='matern2.5', scale_est=True,
                connect=np.arange(1)),
         kernel(length=np.array([0.2]), name='matern2.5', scale_est=True,
                connect=np.arange(1))],
        [ZIP()])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), device=dev)
    mu, var = emu.predict(Xt, method='mean_var')
    rmse_mean = float(np.sqrt(np.mean((np.asarray(mu).flatten()
                                       - Yt_mean.flatten()) ** 2)))
    nll = float(np.asarray(emu.nllik(Xt, test_Yt)[0]))
    return {"rmse_mean_vs_truth": rmse_mean, "test_nllik": nll}


def wine(seed, dev):
    """parity.py:213-246: 3-layer DGP (13 GP / 3 GP / Categorical), wine
    80/20 split, train(N=500), N=50; scikit-learn's GPC figures on the same
    split from the data file."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, Categorical, nb_seed
    np.random.seed(seed)
    nb_seed(seed)
    Xtr, Xte, ytr, yte, w = _wine()
    layer1 = [kernel(length=np.array([1]), name='matern2.5', nugget=1e-6)
              for _ in range(Xtr.shape[1])]
    layer2 = [kernel(length=np.array([1]), name='matern2.5', scale_est=True,
                     nugget=1e-4, nugget_est=True) for _ in range(3)]
    m = dgp(Xtr, ytr.reshape(-1, 1), combine(layer1, layer2, [Categorical()]),
            device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), N=50, device=dev)
    prob = emu.predict(Xte)[0]
    return {"dgp_log_loss": log_loss(yte, prob),
            "dgp_accuracy": accuracy_score(yte, np.argmax(prob, axis=1)),
            "sklearn_gpc_log_loss": round(w["sklearn_gpc_log_loss"], 4),
            "sklearn_gpc_accuracy": round(w["sklearn_gpc_accuracy"], 4),
            "reference_dgp_log_loss": 0.0590, "reference_dgp_accuracy": 1.000}


def wine_reduced(seed, dev):
    """parity.py:249-271: the wine row at train(N=25), N=10."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, Categorical, nb_seed
    np.random.seed(seed)
    nb_seed(seed)
    Xtr, Xte, ytr, yte, _ = _wine()
    layer1 = [kernel(length=np.array([1]), name='matern2.5', nugget=1e-6)
              for _ in range(Xtr.shape[1])]
    layer2 = [kernel(length=np.array([1]), name='matern2.5', scale_est=True,
                     nugget=1e-4, nugget_est=True) for _ in range(3)]
    m = dgp(Xtr, ytr.reshape(-1, 1), combine(layer1, layer2, [Categorical()]),
            device=dev)
    m.train(N=25, disable=True)
    emu = emulator(m.estimate(), N=10, device=dev)
    prob = emu.predict(Xte)[0]
    return {"dgp_log_loss": log_loss(yte, prob),
            "dgp_accuracy": accuracy_score(yte, np.argmax(prob, axis=1))}


def linked(seed, dev):
    """parity.py:274-294: GP(f1) -> DGP(f2) via container/lgp."""
    from dgp_tpu_torch import dgp, gp, kernel, combine, container, lgp, nb_seed
    nb_seed(seed)
    X1, Y1, X2, Y2, z, truth = pdata.linked_data()
    m1 = gp(X1, Y1, kernel(length=np.array([1.]), name='matern2.5', scale_est=True),
            device=dev)
    m1.train()
    c1 = container(m1.export(), local_input_idx=np.array([0]), device=dev)
    all_layer = combine(
        [kernel(length=np.array([1.]), name='matern2.5')],
        [kernel(length=np.array([1.]), name='matern2.5', scale_est=True,
                connect=np.arange(1))])
    m2 = dgp(X2, [Y2], all_layer, device=dev)
    m2.train(N=500, disable=True)
    c2 = container(m2.estimate(), local_input_idx=np.array([0]), device=dev)
    lm = lgp([[c1], [c2]], device=dev)
    ml, vl = lm.predict(z)
    return {"rmse_vs_composed_truth": float(np.sqrt(np.mean(
        (np.asarray(ml[0]).flatten() - truth.flatten()) ** 2)))}


def vecchia(seed, dev):
    """parity.py:297-314: 2-layer Vecchia DGP, n=5000 (m=25),
    train(N=100, chunk_size=16), predict 2000 points at m=200."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, nb_seed
    nb_seed(seed)
    X, Y, z, truth = pdata.vecchia_data()
    all_layer = combine(
        [kernel(length=np.array([0.5]), name='sexp')],
        [kernel(length=np.array([0.5]), name='sexp', nugget_est=True,
                scale_est=True, connect=np.arange(1))])
    m = dgp(X, Y, all_layer, vecchia=True, device=dev)
    m.train(N=100, disable=True, chunk_size=16)
    emu = emulator(m.estimate(), device=dev)
    mu, var = emu.predict(z, method='mean_var', m=200)
    return {"rmse_vs_truth": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "noise_floor_sigma": 0.05}


def multioutput(seed, dev):
    """parity.py:317-339: 2-layer DGP, n=13, two outputs sharing one
    latent layer."""
    from dgp_tpu_torch import dgp, kernel, combine, emulator, nb_seed
    nb_seed(seed)
    X, Y, z, truth = pdata.multioutput_data()
    all_layer = combine(
        [kernel(length=np.array([.5]), name='sexp')],
        [kernel(length=np.array([.5]), name='sexp', connect=np.arange(1),
                scale_est=True),
         kernel(length=np.array([.5]), name='sexp', connect=np.arange(1),
                scale_est=True)])
    m = dgp(X, [Y], all_layer, device=dev)
    m.train(N=500, disable=True)
    emu = emulator(m.estimate(), device=dev)
    mu = np.asarray(emu.predict(z, method='mean_var')[0])
    return {"rmse_vs_truth": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "rmse_out1": float(np.sqrt(np.mean((mu[:, 0] - truth[:, 0]) ** 2))),
            "rmse_out2": float(np.sqrt(np.mean((mu[:, 1] - truth[:, 1]) ** 2)))}


ROWS = {"step": step, "2d": twod, "multioutput": multioutput, "poisson": poisson,
        "dgp_poisson": dgp_poisson, "negbin": negbin, "zip": zip_demo,
        "linked": linked, "vecchia": vecchia, "vecchia_f32": vecchia,
        "wine_reduced": wine_reduced, "wine": wine}
#: parity.py's nb_seed of the rows with one seed
SEED = {"vecchia": 123, "vecchia_f32": 123}


def seeds_of(name):
    return SEEDS.get(name, (SEED.get(name, 99),))


# ----------------------------------------------------------------------
# workers and the record
# ----------------------------------------------------------------------
def run_task(task):
    """One row at one SEM seed in this (worker) process, on ``device``
    (None: the current card): its unrounded figures, wall seconds, dtype,
    kernel launches and large-block route calls."""
    import torch
    import dgp_tpu_torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore
    name, seed, device = task
    torch.set_num_threads(1)
    dt = DTYPES.get(name, "float64")
    dgp_tpu_torch.set_default_dtype(dt)
    cv.reset_launch_counts()
    vcore.reset_route_counts()
    t0 = time.perf_counter()
    out = ROWS[name](seed, device)
    if device is None:
        torch.cuda.synchronize()
    return {"row": name, "nb_seed": seed, "figures": out,
            "wall_s": time.perf_counter() - t0, "dtype": dt,
            "launches": {k: c["launches"] for k, c in cv.launch_counts().items()},
            "route_calls": vcore.route_counts()}


def _round(v):
    if isinstance(v, float):
        return round(v, 4)
    if isinstance(v, list):
        return [_round(x) for x in v]
    return v


def assemble(name, runs, anchors, card, platform="gpu"):
    """A row of PARITY_torch.json from its runs: the figures (the medians
    over the seeds where there are several), rounded to 4 places as
    parity.py rounds them, the anchors and the gate."""
    keys = runs[0]["figures"].keys()
    if len(runs) == 1:
        row = {k: _round(v) for k, v in runs[0]["figures"].items()}
    else:
        row = {k: (_round(statistics.median(r["figures"][k] for r in runs))
                   if isinstance(runs[0]["figures"][k], float) else runs[0]["figures"][k])
               for k in keys}
    gate_name = GATE_OF.get(name, name)
    ref = anchors.get(gate_name)
    if ref and "error" not in ref:
        row["reference_on_same_draw"] = {k: v for k, v in ref.items()
                                         if k not in ("wall_s", "source")}
    parity.apply_gate(gate_name, row)
    row.update({
        "gate_of": gate_name,
        "nb_seeds": [r["nb_seed"] for r in runs],
        "by_seed": [{"nb_seed": r["nb_seed"], "wall_s": r["wall_s"], **r["figures"]}
                    for r in runs],
        "wall_s": max(r["wall_s"] for r in runs),
        "dtype": runs[0]["dtype"],
        "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
        "route_calls": {k: sum(r["route_calls"][k] for r in runs)
                        for k in runs[0]["route_calls"]},
        "platform": platform, "nvidia_smi": card,
    })
    return row


def main(argv):
    import torch
    opts = {"--workers": str(min(8, os.cpu_count() or 1)), "--out": OUT,
            "--seeds": None, "--device": None}
    for key in opts:
        if key in argv:
            i = argv.index(key)
            opts[key] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    workers, out_path, device = int(opts["--workers"]), opts["--out"], opts["--device"]
    if device not in (None, "cpu"):
        print("parity_torch: --device takes only cpu", file=sys.stderr)
        return 2
    if device is None and not torch.cuda.is_available():
        print("parity_torch: CUDA is not available", file=sys.stderr)
        return 1
    names = [n for n in ORDER if not argv or n in argv]
    unknown = set(argv) - set(ROWS)
    if unknown:
        print(f"parity_torch: unknown rows {sorted(unknown)}", file=sys.stderr)
        return 2
    seeds = (None if opts["--seeds"] is None
             else tuple(int(v) for v in opts["--seeds"].split(",")))

    def seeds_here(name):
        return seeds or seeds_of(name)
    if device is None:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = f"cpu ({os.cpu_count()} cores)"
    print(card, flush=True)
    with open(ANCHORS) as fh:
        anchors = json.load(fh)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            results = json.load(fh)
    tasks = [(n, s, device) for n in names for s in seeds_here(n)]
    t0 = time.perf_counter()
    results.update({k: {"waiting": v} for k, v in WAITING.items()})
    call = {"rows": names, "workers": min(workers, len(tasks)), "nvidia_smi": card,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    results["_calls"] = results.get("_calls", []) + [call]
    runs = {n: [] for n in names}
    with multiprocessing.get_context("spawn").Pool(min(workers, len(tasks))) as pool:
        # each row is written as soon as its last seed is in
        for r in pool.imap_unordered(run_task, tasks):
            name = r["row"]
            runs[name].append(r)
            if len(runs[name]) < len(seeds_here(name)):
                continue
            results[name] = assemble(name, sorted(runs[name], key=lambda u: tasks.index(
                (name, u["nb_seed"], device))), anchors, card,
                "gpu" if device is None else "cpu")
            call["seconds"] = time.perf_counter() - t0
            with open(out_path, "w") as fh:
                json.dump(results, fh, indent=1)
                fh.write("\n")
            print(json.dumps({name: {k: results[name][k] for k in ("gate", "wall_s")}}),
                  flush=True)
    failed = [n for n in names if not results[n]["gate"]["pass"]]
    print(json.dumps({"pass": not failed, "failed": failed, "seconds": call["seconds"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
