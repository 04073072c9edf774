"""Write dgp_tpu_torch/data/vecchia_si_n2000.json from a dgp_tpu CPU run.

Trains the headline configuration of bench.py (2-layer Vecchia DGP, sexp,
n=2000, m=25, layer 2 wired to the global input with its nugget and scale
estimated) with the JAX package in float64 on the CPU, and records

  * the estimated per-node hyper-parameters,
  * the training length N, the seed and the source commit,
  * the RMSE against the noiseless truth of a 5-imputation emulator at
    m=50, measured by the protocol chip_smoke.py runs on the port: a fresh
    dgp built on the same data with the recorded hyper-parameters, then
    emulator(m.estimate(), N=5) and predict on 1000 points.  One figure per
    seed, so the file also carries the JAX package's own seed spread.

With the argument ``linked`` it writes dgp_tpu_torch/data/linked_n2000.json
instead: the protocol of chip_smoke.py's `linked` phase (`LINKED`, the
model_linking notebook's GP -> DGP system at the main path's width) and the
JAX package's figures under it:

  * model 1, a Vecchia `gp` (Matern-2.5, length 1, scale and nugget
    estimated, m=25; ordering from numpy seed `gp_ord_seed`) on f1 plus
    noise, trained; its hyper-parameters;
  * model 2, the headline DGP structure above on f2 plus noise over f1's
    range, trained for N_TRAIN SEM iterations; its hyper-parameters;
  * at each of `lgp_seeds`: a fresh dgp at model 2's hyper-parameters,
    container(m2.estimate()), lgp([[container(m1.export())], [c2]],
    N=lgp_N) and predict on `n_test` points of [-1, 1] at m=`pred_m`; the
    RMSE against f2(f1(z)) and its median over the seeds.

Usage (from the repository root):

    JAX_PLATFORMS=cpu python tools/make_torch_params.py [N_TRAIN]
    JAX_PLATFORMS=cpu python tools/make_torch_params.py linked [N_TRAIN]
"""
import json
import subprocess
import sys
import time

import numpy as np

SEED = 123
N = 2000
M = 25
OUT = "dgp_tpu_torch/data/vecchia_si_n2000.json"
LINKED_OUT = "dgp_tpu_torch/data/linked_n2000.json"
#: the `linked` protocol: data (model 1 on [-1, 1], model 2 on f1's range
#: [0, 1]), model 1's gp, model 2's training, the linked system and its test
LINKED = {"n": N, "data_seed": 7, "y1_noise": 0.01, "y2_noise": 0.05, "m": M,
          "gp_kernel": "matern2.5", "gp_length": 1.0, "gp_ord_seed": 123,
          "train_seed": SEED, "train_chunk_size": 16, "lgp_N": 10, "pred_m": 50,
          "n_test": 1000, "lgp_seeds": [1, 2, 3]}


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data():
    rng = np.random.RandomState(SEED)
    X = rng.rand(N, 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(N, 1)
    return X, Y


def f1(x):
    return (np.sin(7.5 * x) + 1) / 2


def f2(x):
    return (2 / 3 * np.sin(2 * (2 * x - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * x - 1)) ** 2) - 1 / 3)


def linked_data(p=LINKED):
    """(X1, Y1, X2, Y2) of the `linked` protocol: f1 = (sin 7.5x + 1)/2 and
    f2 of tools/parity_data.py:95-97, so that f2(f1(x)) is `func`."""
    rng = np.random.RandomState(p["data_seed"])
    X1 = rng.uniform(-1, 1, (p["n"], 1))
    Y1 = f1(X1) + p["y1_noise"] * rng.randn(p["n"], 1)
    X2 = rng.uniform(0, 1, (p["n"], 1))
    Y2 = f2(X2) + p["y2_noise"] * rng.randn(p["n"], 1)
    return X1, Y1, X2, Y2


def linked_gp(pkg, X1, Y1, p=LINKED, **kw):
    """Model 1 of the `linked` protocol with package ``pkg`` (``kw`` goes to
    the gp constructor), trained."""
    k = pkg.kernel(length=np.array([p["gp_length"]]), name=p["gp_kernel"],
                   scale_est=True, nugget_est=True)
    np.random.seed(p["gp_ord_seed"])
    m = pkg.gp(X1, Y1, k, vecchia=True, m=p["m"], **kw)
    m.train()
    return m


def linked_system(pkg, c1, X2, Y2, hyper, seed, p=LINKED, **kw):
    """The `linked` protocol's system at one seed: a fresh dgp at model 2's
    hyper-parameters, its container and lgp([[c1], [c2]]) (``kw`` goes to
    dgp, container and lgp)."""
    pkg.nb_seed(seed)
    np.random.seed(seed)
    m2 = pkg.dgp(X2, Y2, layers(pkg.kernel, pkg.combine, hyper), vecchia=True,
                 m=p["m"], **kw)
    c2 = pkg.container(m2.estimate(), local_input_idx=np.array([0]), **kw)
    return pkg.lgp([[c1], [c2]], N=p["lgp_N"], **kw)


def layers(kernel, combine, hyper=None):
    h = hyper or [{'length': [0.5], 'scale': 1.0, 'nugget': 1e-4}] * 2
    layer1 = [kernel(length=np.array(h[0]['length']), scale=h[0]['scale'],
                     nugget=h[0]['nugget'], name='sexp')]
    layer2 = [kernel(length=np.array(h[1]['length']), scale=h[1]['scale'],
                     nugget=h[1]['nugget'], name='sexp', nugget_est=True,
                     scale_est=True, connect=np.arange(1))]
    return combine(layer1, layer2)


def main():
    import dgp_tpu
    from dgp_tpu import dgp, kernel, combine, emulator, nb_seed

    n_train = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    X, Y = data()
    z = np.linspace(-1, 1, 1000).reshape(-1, 1)

    nb_seed(SEED)
    t0 = time.time()
    m = dgp(X, Y, layers(kernel, combine), vecchia=True, m=M)
    m.train(N=n_train, disable=True, chunk_size=16)
    print(f"trained N={n_train} in {time.time() - t0:.1f} s", flush=True)
    est = m.estimate()
    hyper = [{'length': [float(v) for v in layer[0].length],
              'scale': float(layer[0].scale[0]),
              'nugget': float(layer[0].nugget[0])} for layer in est]
    mu, _ = emulator(est, N=5).predict(z, m=50)
    rmse_trained = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    print("hyper", hyper, "rmse_trained", rmse_trained, flush=True)

    # the smoke protocol: fresh model at the recorded hyper-parameters
    rmse_fresh = {}
    for seed in (SEED, 1, 2):
        nb_seed(seed)
        m2 = dgp(X, Y, layers(kernel, combine, hyper), vecchia=True, m=M)
        mu, _ = emulator(m2.estimate(), N=5).predict(z, m=50)
        rmse_fresh[str(seed)] = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
        print("seed", seed, "rmse", rmse_fresh[str(seed)], flush=True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                            text=True).stdout.strip()
    nodes = []
    for l, h in enumerate(hyper):
        nd = {'name': 'sexp', 'length': h['length'], 'scale': h['scale'],
              'nugget': h['nugget'], 'nugget_est': l == 1,
              'scale_est': l == 1}
        if l == 1:
            nd['connect'] = [0]
        nodes.append([nd])
    out = {
        'config': {'n': N, 'm': M, 'data_seed': SEED,
                   'data': 'bench.py:45-64 (RandomState(123), func + 0.05 noise)',
                   'vecchia': True},
        'source': {'package': 'dgp_tpu', 'version': dgp_tpu.__version__,
                   'commit': commit, 'platform': 'cpu', 'dtype': 'float64',
                   'train_N': n_train, 'train_chunk_size': 16,
                   'nb_seed': SEED},
        'layers': nodes,
        'emulator': {'N': 5, 'pred_m': 50, 'n_test': 1000,
                     'rmse_trained_model': rmse_trained,
                     'rmse_fresh_by_seed': rmse_fresh,
                     'rmse_gate_ref': float(np.median(list(rmse_fresh.values())))},
    }
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print("wrote", OUT)


def main_linked():
    import dgp_tpu
    from dgp_tpu import dgp, kernel, combine, container, nb_seed
    from dgp_tpu.models import linked_ensemble

    # model 2's layer 2 is wired to the DGP's input, which model 1 makes
    # stochastic: its linked prediction is dense (n, n) second moments per
    # query (linkgp_prediction_full), which dgp_tpu's query chunks do not
    # count; small chunks keep them within this host's memory
    linked_ensemble._CHUNK = 16
    p = LINKED
    n_train = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    X1, Y1, X2, Y2 = linked_data()
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                            text=True).stdout.strip()
    out = {"protocol": dict(p, train_N=n_train),
           "source": {"script": "tools/make_torch_params.py linked",
                      "package": "dgp_tpu", "version": dgp_tpu.__version__,
                      "commit": commit, "platform": "cpu", "dtype": "float64"}}

    def write():
        with open(LINKED_OUT, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")

    t0 = time.time()
    m1 = linked_gp(dgp_tpu, X1, Y1)
    out["gp"] = {"scale": float(m1.kernel.scale[0]), "length": m1.kernel.length.tolist(),
                 "nugget": float(m1.kernel.nugget[0]),
                 "log_likelihood": float(m1.kernel.log_likelihood_func()),
                 "train_s": time.time() - t0}
    print("gp", out["gp"], flush=True)
    write()

    nb_seed(p["train_seed"])
    t0 = time.time()
    m = dgp(X2, Y2, layers(kernel, combine), vecchia=True, m=p["m"])
    m.train(N=n_train, disable=True, chunk_size=p["train_chunk_size"])
    est = m.estimate()
    hyper = [{'length': [float(v) for v in layer[0].length],
              'scale': float(layer[0].scale[0]),
              'nugget': float(layer[0].nugget[0])} for layer in est]
    out["dgp"] = {"layers": hyper, "train_s": time.time() - t0}
    print("dgp", out["dgp"], flush=True)
    write()

    c1 = container(m1.export(), local_input_idx=np.array([0]))
    rmse = {}
    for seed in p["lgp_seeds"]:
        t0 = time.time()
        system = linked_system(dgp_tpu, c1, X2, Y2, hyper, seed)
        mu, var = system.predict(z, m=p["pred_m"])
        rmse[str(seed)] = float(np.sqrt(np.mean((mu[0] - func(z)) ** 2)))
        print("seed", seed, "rmse", rmse[str(seed)], "s", time.time() - t0, flush=True)
    out["lgp"] = {"rmse_by_seed": rmse, "rmse_median": float(np.median(list(rmse.values())))}
    write()
    print("wrote", LINKED_OUT)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "linked":
        main_linked()
    else:
        main()
