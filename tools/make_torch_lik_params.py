"""Reference figures and seed spreads of the likelihood models that
dgp_tpu_torch is held to: one tool, parameterised by protocol and package.

Protocols (``PROTOCOLS``), each a function of (package, seed) that trains one
model and returns its quality figures:

  hetero         chip_smoke.py's `lik_vecchia` phase: bench.py's function on
                 n=2000 inputs of [-1, 1] (seed 123) plus Gaussian noise of
                 sd(x) = 0.05 exp(0.8 x); a 3-layer Vecchia DGP (m=25), [1
                 GP] -> [2 GPs, connected to the global input, scale
                 estimated] -> [Hetero()], squared-exponential kernels;
                 `train(N, chunk_size=16)`, `emulator(m.estimate(), N=5)`,
                 `predict` at m=50 on 1000 points (RMSE of the predicted
                 mean against the noiseless truth, of the predicted variance
                 against sd(x)^2) and `nllik` on 2000 held-out points (seed
                 7, sorted) beside the oracle's (the true mean and sd).
  poisson_small  tests/test_torch_lik.py's seed-spread test: 15 sites of
                 [0, 1], three Poisson counts each (RandomState(0)), rate
                 exp(1 + sin(5 x)); [GP 0.5] -> [GP 0.2, scale estimated,
                 global input] -> [Poisson()], matern2.5, dense; train(N=10),
                 emulator(N=3), nllik on 100 fresh points (RandomState(1)).
  negbin, dgp_poisson   the rows of tools/parity.py (:130-185) at their full
                 protocols on the data of tools/parity_data.py (which pins
                 the data's generator): only nb_seed varies.

Three ways to run it, from the repository root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/make_torch_lik_params.py [N]

writes dgp_tpu_torch/data/lik_n2000.json: the `hetero` protocol and dgp_tpu's
figures under it at the protocol's seed, one set per emulator seed (the gates
take the median); hours on a CPU at the default N.

    python3 tools/make_torch_lik_params.py seeds PROTOCOL SIDE SEED [SEED ...]

prints one JSON line of figures per seed.  SIDE is `port` (dgp_tpu_torch on
the current CUDA device; imports no JAX, and prints the card's name and power
limit first), `port-cpu` (dgp_tpu_torch on the CPU) or `jax` (dgp_tpu; set
JAX_PLATFORMS=cpu).  For `hetero`, `--train-N N`, `--n N` and `--m M` replace
the protocol's SEM iterations, data size and conditioning-set size, and each
seed gets one emulator of the same seed.

    python3 tools/make_torch_lik_params.py store PROTOCOL FILE [FILE ...]

keeps lines that `seeds` printed: for `hetero` under "by_training_seed" of
lik_n2000.json (and dgp_tpu's test nllik at the protocol's training seeds
under "jax"), for the other protocols under [PROTOCOL][SIDE] of
tests/torch_lik_spread.json.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "dgp_tpu_torch" / "data" / "lik_n2000.json"
SPREAD = ROOT / "tests" / "torch_lik_spread.json"

PROTOCOL = {
    "n": 2000, "data_seed": 123, "noise_sd": "0.05 * exp(0.8 x)", "kernel": "sexp",
    "m": 25, "length": [0.5, 0.2, 0.2], "nugget": 1e-4, "train_N": 100,
    "chunk_size": 16, "nb_seed": 123, "emulator_N": 5, "emulator_seeds": [123, 1, 2],
    "pred_m": 50, "n_test": 1000, "n_heldout": 2000, "heldout_seed": 7,
    "training_seeds": [123, 1, 2],
}
JAX_CPU = "cpu (dgp_tpu on JAX)"


# ----------------------------------------------------------------------
# hetero
# ----------------------------------------------------------------------
def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def noise_sd(x):
    return 0.05 * np.exp(0.8 * x)


def data(p=PROTOCOL):
    """(X, Y, z, Xh, Yh): training data, the test grid, held-out data."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = func(X) + noise_sd(X) * rng.randn(p["n"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    rh = np.random.RandomState(p["heldout_seed"])
    # in ascending order: dgp_tpu's nllik pairs y with the sorted inputs
    Xh = np.sort(rh.rand(p["n_heldout"], 1) * 2 - 1, axis=0)
    Yh = func(Xh) + noise_sd(Xh) * rh.randn(p["n_heldout"], 1)
    return X, Y, z, Xh, Yh


def oracle_nllik(Xh, Yh):
    sd = noise_sd(Xh)
    return float(np.mean(0.5 * np.log(2 * np.pi * sd ** 2)
                         + (Yh - func(Xh)) ** 2 / (2 * sd ** 2)))


def layers(pkg, p=PROTOCOL):
    l0, l1, l2 = p["length"]
    k = pkg.kernel
    return pkg.combine(
        [k(length=np.array([l0]), name=p["kernel"], nugget=p["nugget"])],
        [k(length=np.array([l]), name=p["kernel"], nugget=p["nugget"], scale_est=True,
           connect=np.arange(1)) for l in (l1, l2)],
        [pkg.Hetero()])


def figures(emu, p=PROTOCOL):
    """The quality figures of one emulator under the protocol."""
    _, _, z, Xh, Yh = data(p)
    mu, var = emu.predict(z, m=p["pred_m"])
    nll = float(np.asarray(emu.nllik(Xh, Yh, m=p["pred_m"])[0]))
    return {"rmse_mean": float(np.sqrt(np.mean((mu - func(z)) ** 2))),
            "rmse_var": float(np.sqrt(np.mean((var - noise_sd(z) ** 2) ** 2))),
            "test_nllik": nll}


def run(pkg, p=PROTOCOL, log=print, **kw):
    """The `hetero` protocol with package ``pkg`` (dgp_tpu or dgp_tpu_torch;
    ``kw`` goes to the dgp and emulator constructors): a dict of the figures."""
    X, Y, _, Xh, Yh = data(p)
    pkg.nb_seed(p["nb_seed"])
    t0 = time.perf_counter()
    m = pkg.dgp(X, Y, layers(pkg, p), vecchia=True, m=p["m"], **kw)
    log(f"constructed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m.train(N=p["train_N"], disable=True, chunk_size=p["chunk_size"])
    out = {"train_s": time.perf_counter() - t0}
    log(f"trained N={p['train_N']} in {out['train_s']:.1f} s")
    est = m.estimate()
    out["trained"] = [{"scale": float(nd.scale[0]), "length": nd.length.tolist(),
                       "nugget": float(nd.nugget[0])}
                      for layer in est for nd in layer if nd.type == 'gp']
    out["by_emulator_seed"] = {}
    for seed in p["emulator_seeds"]:
        pkg.nb_seed(seed)
        out["by_emulator_seed"][str(seed)] = figures(
            pkg.emulator(est, N=p["emulator_N"], **kw), p)
        log(f"emulator seed {seed}: {out['by_emulator_seed'][str(seed)]}")
    for key in ("rmse_mean", "rmse_var", "test_nllik"):
        out[key] = float(np.median([f[key] for f in out["by_emulator_seed"].values()]))
    out["oracle_nllik"] = oracle_nllik(Xh, Yh)
    return out


def run_hetero(pkg, seed, p=None, **kw):
    p = p or json.loads(OUT.read_text())["protocol"]
    res = run(pkg, dict(p, nb_seed=seed, emulator_seeds=[seed]), log=lambda s: None, **kw)
    res.pop("by_emulator_seed")
    return dict(res, train_N=p["train_N"], n=p["n"], m=p["m"])


# ----------------------------------------------------------------------
# poisson_small
# ----------------------------------------------------------------------
SMALL = {"n_sites": 15, "n_rep": 3, "train_N": 10, "emulator_N": 3, "n_test": 100}


def small_rate(x):
    return np.exp(1.0 + np.sin(5.0 * x))


def small_data():
    rs = np.random.RandomState(0)
    X = np.tile(np.linspace(0, 1, SMALL["n_sites"]), SMALL["n_rep"])[:, None]
    Y = rs.poisson(small_rate(X)).astype(float)
    rt = np.random.RandomState(1)
    z = np.sort(rt.rand(SMALL["n_test"], 1), axis=0)
    return X, Y, z, rt.poisson(small_rate(z)).astype(float)


def run_poisson_small(pkg, seed, **kw):
    X, Y, z, yz = small_data()
    k = pkg.kernel
    structure = pkg.combine([k(length=np.array([0.5]), name='matern2.5')],
                            [k(length=np.array([0.2]), name='matern2.5', scale_est=True,
                               connect=np.arange(1))],
                            [pkg.Poisson()])
    pkg.nb_seed(seed)
    m = pkg.dgp(X, Y, structure, **kw)
    m.train(N=SMALL["train_N"], disable=True)
    emu = pkg.emulator(m.estimate(), N=SMALL["emulator_N"], **kw)
    return {"test_nllik": float(np.asarray(emu.nllik(z, yz)[0]))}


# ----------------------------------------------------------------------
# the parity rows
# ----------------------------------------------------------------------
def run_parity_row(row, pkg, seed, **kw):
    sys.path.insert(0, str(ROOT / "tools"))
    import parity_data as pdata

    def k(length, **a):
        return pkg.kernel(length=np.array([length]), name='matern2.5', **a)
    pkg.nb_seed(seed)
    if row == "dgp_poisson":
        X, Y, Xt, test_Y, _ = pdata.poisson_data()
        truth, n_train = None, 1000
        structure = pkg.combine([k(0.5)], [k(0.1, scale_est=True, connect=np.arange(1))],
                                [pkg.Poisson()])
    else:
        X, Y, Xt, truth, test_Y = pdata.negbin_data()
        n_train = 500
        structure = pkg.combine([k(0.5)], [k(0.02, scale_est=True, connect=np.arange(1))
                                           for _ in range(2)], [pkg.NegBin()])
    t0 = time.time()
    m = pkg.dgp(X, [Y], structure, **kw)
    m.train(N=n_train, disable=True)
    emu = pkg.emulator(m.estimate(), N=50, **kw)
    out = {"test_nllik": float(np.asarray(emu.nllik(Xt, test_Y)[0]))}
    if truth is not None:
        mu, _ = emu.predict(Xt)
        out["rmse_mean_vs_truth"] = float(np.sqrt(np.mean((np.asarray(mu).flatten()
                                                           - truth.flatten()) ** 2)))
    out["seconds"] = time.time() - t0
    return out


PROTOCOLS = {
    "hetero": run_hetero,
    "poisson_small": run_poisson_small,
    "negbin": lambda pkg, seed, **kw: run_parity_row("negbin", pkg, seed, **kw),
    "dgp_poisson": lambda pkg, seed, **kw: run_parity_row("dgp_poisson", pkg, seed, **kw),
}


# ----------------------------------------------------------------------
def seeds(protocol, side, args):
    """One JSON line of ``protocol``'s figures per seed of ``args``."""
    kw, over = {}, {}
    for flag, key in (("--train-N", "train_N"), ("--n", "n"), ("--m", "m")):
        if flag in args:
            i = args.index(flag)
            over[key] = int(args[i + 1])
            args = args[:i] + args[i + 2:]
    if over:
        kw["p"] = dict(json.loads(OUT.read_text())["protocol"], **over)
    if side == "port":
        import torch
        import dgp_tpu_torch as pkg
        device = torch.cuda.get_device_name(0)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    elif side == "port-cpu":
        import dgp_tpu_torch as pkg
        device, kw["device"] = "cpu (dgp_tpu_torch)", "cpu"
    else:
        import dgp_tpu as pkg
        device = JAX_CPU
    for seed in map(int, args):
        print(json.dumps(dict(PROTOCOLS[protocol](pkg, seed, **kw), protocol=protocol,
                              side=side, nb_seed=seed, device=device)), flush=True)


def _lines(files):
    """The JSON lines of ``files``, each with the card line that `seeds
    ... port` printed before it (if any) under "card"."""
    for f in files:
        card = None
        for line in Path(f).read_text().splitlines():
            if not line.startswith("{"):
                card = line.strip()
                continue
            row = json.loads(line)
            # an nllik whose predicted density underflowed is kept as text
            row = {k: str(v) if isinstance(v, float) and not np.isfinite(v) else v
                   for k, v in row.items()}
            if card is not None:
                row["card"] = card
            yield row


def store(protocol, files):
    rows = [r for r in _lines(files) if r.pop("protocol") == protocol]
    if protocol != "hetero":
        stored = json.loads(SPREAD.read_text())
        for r in rows:
            mine = stored.setdefault(protocol, {}).setdefault(r.pop("side"), [])
            r.pop("device")
            mine[:] = [o for o in mine if o["nb_seed"] != r["nb_seed"]] + [r]
        SPREAD.write_text(json.dumps(stored, indent=1) + "\n")
        return
    stored = json.loads(OUT.read_text())
    p = stored["protocol"]
    for r in rows:
        r.pop("side")
    stored["by_training_seed"] = sorted(
        stored.get("by_training_seed", []) + rows,
        key=lambda r: (r["device"], r.get("n", p["n"]), r["train_N"], r["nb_seed"]))
    # dgp_tpu under the protocol as it stands, by training seed (one emulator
    # of the same seed each)
    by_seed = {str(p["nb_seed"]):
               stored["jax"]["by_emulator_seed"][str(p["nb_seed"])]["test_nllik"]}
    for r in stored["by_training_seed"]:
        if (r["device"] == JAX_CPU and r.get("n", p["n"]) == p["n"]
                and r.get("m", p["m"]) == p["m"] and r["train_N"] == p["train_N"]):
            by_seed[str(r["nb_seed"])] = r["test_nllik"]
    stored["jax"]["test_nllik_by_training_seed"] = by_seed
    OUT.write_text(json.dumps(stored, indent=1) + "\n")


def main():
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["store"]:
        return store(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["seeds"]:
        return seeds(sys.argv[2], sys.argv[3], sys.argv[4:])
    import dgp_tpu
    p = dict(PROTOCOL)
    if len(sys.argv) > 1:
        p["train_N"] = int(sys.argv[1])
    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "dgp_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    res = run(dgp_tpu, p, log=lambda s: print(s, flush=True))
    res["test_nllik_by_training_seed"] = {
        str(p["nb_seed"]): res["by_emulator_seed"][str(p["nb_seed"])]["test_nllik"]}
    OUT.write_text(json.dumps({
        "protocol": p,
        "source": "tools/make_torch_lik_params.py, dgp_tpu on JAX (CPU, float64), "
                  f"dgp_tpu as of commit {commit}",
        "jax": res}, indent=1) + "\n")
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
