"""Readings of a cell's compared numbers with each of its planted faults:
the faults its driver lists in ``FAULTS`` (or, where the driver lists
none, `benchmark/harness/faults.py`'s), each planted under the timed path
of one run a seed, all in one process on the card.  Beside
`benchmark/calibrate.py`, whose ``--fault`` reaches only the harness's
faults, this sets a limit's upper side from the cell's own faults.

    python3 tools/calibrate_faults.py --workload <cell> --seeds 1,2 \\
        --seconds 8 [--out FILE]

One JSON line per run: the fault, the number that has to catch it, the
seed, ``correct`` and every compared number.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import core, faults  # noqa: E402
from benchmark.harness.hooks import Hooks  # noqa: E402


def cell_faults(cell):
    """(fault, number) pairs planted for ``cell``: its driver's, else the
    harness's."""
    mix = core.cell_files(cell)[2]
    driver = importlib.import_module(f"benchmark.traffic.{mix['driver']}")
    return getattr(driver, "FAULTS", {}).get(cell) or faults.FAULTS.get(cell, [])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dtype = core.cell_files(args.workload)[1]["dtype"]
    out = open(args.out, "a") if args.out else None
    for fault, number in cell_faults(args.workload):
        for seed in (int(s) for s in args.seeds.split(",") if s):
            t0 = time.perf_counter()
            line = {"fault": fault.__name__, "number": number, "seed": seed}
            try:
                with Hooks() as hooks:
                    fault(hooks)
                    r = core.run_cell(args.workload, seed, args.seconds, 0, t0, dtype=dtype)
                line.update(correct=r["correct"], work=r["work"], checks=r["checks"])
            except Exception as exc:    # a fault that stops the run has been caught
                line["error"] = repr(exc)
            line["seconds"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()


if __name__ == "__main__":
    main()
