"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result (one JSON object);
the last lines of standard error are the compared numbers with their
limits.  See benchmark/README.md.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import core
    sys.exit(core.main(sys.argv[1:], T_START))
