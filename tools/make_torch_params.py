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

Usage (from the repository root):

    JAX_PLATFORMS=cpu python tools/make_torch_params.py [N_TRAIN]
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


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data():
    rng = np.random.RandomState(SEED)
    X = rng.rand(N, 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(N, 1)
    return X, Y


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


if __name__ == "__main__":
    main()
