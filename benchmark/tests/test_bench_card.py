"""On the card: each cell runs from the command line with a short window,
prints a correct result line that names the card, and in a traced run the
trace's device time."""
import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace, cuda):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
