"""The comparison that decides ``correct``, driven through whole runs of
each cell at a size the CPU holds: the program as configured passes; the
control (the program in float32, the precision below the configuration's)
fails; and every fault that a cell can have, planted under the timed path
(`harness/faults.py`), fails.  One chip: no exchange between chips to leave
out."""
import pytest

from benchmark.harness import faults
from benchmark.harness.hooks import Hooks
from conftest import CELLS, HELD_OUT, run_small


@pytest.mark.parametrize("cell", CELLS + HELD_OUT)
def test_program_passes_and_control_fails(cell, monkeypatch):
    good = run_small(cell, monkeypatch)
    assert good["correct"], good["checks"]
    low = run_small(cell, monkeypatch, dtype="float32")
    assert not low["correct"], low["checks"]


@pytest.mark.parametrize("cell,fault,number", [(c, f, k) for c, fs in faults.FAULTS.items()
                                               for f, k in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_planted_fault_fails(cell, fault, number, monkeypatch):
    """The fault fails the run, and the number meant to catch it reads
    above its limit."""
    with Hooks() as hooks:
        fault(hooks)
        r = run_small(cell, monkeypatch)
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], r["checks"]
