"""SEM-seed spread of a row of tools/parity.py on dgp_tpu (the JAX
package), on the CPU: the row's own protocol and data draw, with the seed
its `nb_seed` call sets replaced by each given seed, so that only the SEM
seed changes.  One process per seed (as parity.py runs its rows), at most
four at a time; one JSON line per seed, in seed order.  The port's
counterpart is `tools/parity_torch.py ROW --seeds ...`.

Usage: python tools/parity_jax_seeds.py ROW SEED [SEED ...]
"""
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

import parity  # noqa: E402


def _run_one(row, seed):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import dgp_tpu
    nb_seed = dgp_tpu.nb_seed
    dgp_tpu.nb_seed = lambda _: nb_seed(seed)
    dgp_tpu.set_default_dtype(parity.DTYPES.get(row, "float64"))
    t0 = time.time()
    r = parity.CONFIGS[row]()
    r.update(nb_seed=seed, wall_s=round(time.time() - t0, 1))
    print("SEED_RESULT " + json.dumps(r), flush=True)


def main(row, seeds):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    running, done = [], {}
    queue = list(seeds)
    while queue or running:
        while queue and len(running) < 4:
            s = queue.pop(0)
            running.append((s, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run", row, str(s)],
                env=env, stdout=subprocess.PIPE, text=True)))
        s, proc = running.pop(0)
        out = proc.communicate()[0]
        lines = [ln for ln in out.splitlines() if ln.startswith("SEED_RESULT ")]
        done[s] = (json.loads(lines[-1][len("SEED_RESULT "):]) if lines
                   else {"nb_seed": s, "error": f"rc={proc.returncode}"})
    for s in seeds:
        print(json.dumps({"row": row, **done[s]}), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--run":
        _run_one(sys.argv[2], int(sys.argv[3]))
    else:
        main(sys.argv[1], [int(v) for v in sys.argv[2:]])
