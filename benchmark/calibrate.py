"""Readings of a cell's compared numbers over several seeds, for the program
as its configuration states it and for the control: the same program in
the precision below the configuration's (float32 for float64), each run
with a short window, all in one process; with ``--fault``, every run with
that fault of `harness/faults.py` planted under the timed path.  The
readings set the cells' limits (PERF.md); the benchmark's own runs never
run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 5 [--out FILE]

One JSON line per run: the seed, the precision, ``correct``, set-up
seconds, the units and every compared number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import core, faults  # noqa: E402
from benchmark.harness.hooks import Hooks  # noqa: E402

BELOW = {"float64": "float32"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", help="a fault of harness/faults.py planted in every run")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dtype = core.cell_files(args.workload)[1]["dtype"]
    runs = [(int(s), dtype) for s in args.seeds.split(",") if s]
    runs += [(int(s), BELOW[dtype]) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, dt in runs:
        t0 = time.perf_counter()
        try:
            with Hooks() as hooks:
                if args.fault:
                    faults.by_name(args.fault)(hooks)
                r = core.run_cell(args.workload, seed, args.seconds, 0, t0, dtype=dt)
            line = {"seed": seed, "dtype": dt, "fault": args.fault, "correct": r["correct"],
                    "setup_s": r["metrics"].get("setup_s", {}).get("value"),
                    "attempted": r["attempted"], "work": r["work"], "checks": r["checks"]}
        except Exception as exc:    # a control that fails to run has failed
            line = {"seed": seed, "dtype": dt, "error": repr(exc)}
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()


if __name__ == "__main__":
    main()
