"""Write tests/torch_train_spread.json: the seed spread of a dgp_tpu CPU
training run, which tests/test_torch_train.py holds the port's trained
models against.

Protocol (the same in the test): bench.py's 2-layer Vecchia DGP (sexp,
starting length 0.5 and nugget 1e-4, layer 2 wired to the global input with
its nugget and scale estimated) on n=200 points of bench.py's function
(RandomState(0) data), m=10; for each seed, nb_seed(seed), train(N=48,
chunk_size=16), estimate() (the mean of the final quarter of each
hyper-parameter path) and the RMSE of emulator(N=5).predict at m=20 on 300
points against the noiseless truth.  Ten seeds, float64 on the CPU.

Usage, from the repository root (about 5 minutes on an 8-core host):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/torch_train_spread.py
"""
import json
import subprocess
import sys

import numpy as np

N, M_NN, N_ITER, PRED_M, N_TEST = 200, 10, 48, 20, 300
SEEDS = tuple(range(10))
OUT = "tests/torch_train_spread.json"


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def data():
    rs = np.random.RandomState(0)
    X = rs.rand(N, 1) * 2 - 1
    return X, func(X) + 0.05 * rs.randn(N, 1)


def layers(pkg):
    return pkg.combine([pkg.kernel(length=np.array([0.5]), nugget=1e-4)],
                       [pkg.kernel(length=np.array([0.5]), nugget=1e-4,
                                   nugget_est=True, scale_est=True,
                                   connect=np.arange(1))])


def run(pkg, seed, **kw):
    """(hyper-parameter estimates, RMSE) of one seed under the protocol:
    the trained layer-1 length and layer-2 scale, length and nugget."""
    X, Y = data()
    pkg.nb_seed(seed)
    m = pkg.dgp(X, Y, layers(pkg), vecchia=True, m=M_NN, **kw)
    m.train(N=N_ITER, disable=True, chunk_size=16)
    est = m.estimate()
    z = np.linspace(-1, 1, N_TEST).reshape(-1, 1)
    mu, _ = pkg.emulator(est, N=5, **kw).predict(z, m=PRED_M)
    hyper = {'length1': float(est[0][0].length[0]), 'scale2': float(est[1][0].scale[0]),
             'length2': float(est[1][0].length[0]), 'nugget2': float(est[1][0].nugget[0])}
    return hyper, float(np.sqrt(np.mean((mu - func(z)) ** 2)))


def main():
    import dgp_tpu
    rows = []
    for seed in SEEDS:
        hyper, rmse = run(dgp_tpu, seed)
        rows.append(dict(hyper, rmse=rmse))
        print(seed, rows[-1], flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                            text=True).stdout.strip()
    out = {'source': {'package': 'dgp_tpu', 'commit': commit, 'platform': 'cpu',
                      'dtype': 'float64', 'script': 'tools/torch_train_spread.py'},
           'protocol': {'n': N, 'm': M_NN, 'train_N': N_ITER, 'pred_m': PRED_M,
                        'n_test': N_TEST, 'seeds': list(SEEDS)},
           'by_seed': rows}
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    sys.exit(main())
