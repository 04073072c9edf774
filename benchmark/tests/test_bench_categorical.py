"""The classifier's cell, `dgp3_cat_n5000.sem`, at a size the CPU holds: its
files, its data, its planted faults (`traffic/sem_cat.py`'s ``FAULTS``),
and the readers of the likelihood span and the prior draws' counter.

`conftest.small_files` sizes every cell whose name does not begin with
``vsi`` as the linked system; this module hands it this cell's small
files (n = 80, m = 8, ess_burn 2, 2-iteration chunks after 2), so that the
cases of `test_bench_control.py` and `test_bench_layout.py` over every
cell run it too when the whole directory is collected."""
import copy
import json
import sys

import numpy as np
import pytest

import conftest
from benchmark.harness import core
from benchmark.harness.hooks import Hooks
from benchmark.traffic import sem_cat
from conftest import ROOT, run_small

CELL = "dgp3_cat_n5000.sem"
READERS = ("lik_host_ms_per_it", "sem_prior_passes_per_it")
_small_files = conftest.small_files


def small_files(cell, monkeypatch):
    if cell != CELL:
        return _small_files(cell, monkeypatch)
    spec, cfg, mix = (copy.deepcopy(x) for x in core.cell_files(cell))
    spec.update(check_units=2, check_from=3)
    cfg["data"]["n"] = 80
    cfg.update(vecchia_m=8, ess_burn=2)
    mix.update(warm_iterations=2, chunk=2)
    return spec, cfg, mix


conftest.small_files = small_files


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


class _Trace:
    def __init__(self, **work):
        self.work = work


def test_the_cells_files_agree():
    """The configuration keeps dgpsi's widths (13 matern2.5 nodes over the
    inputs, 3 over their latents, Categorical over 3 classes), cuts
    nothing, and names what it assumed; BENCHMARK.json lists the cell
    under the metrics it reports, and the new readers for it."""
    spec, cfg, mix = core.cell_files(CELL)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    assert cfg["reduced"] == {} and cfg["dtype"] == "float64"
    assert set(cfg["assumed"]) == {"n", "vecchia_m", "data", "ess_burn", "mstep"}
    wide, cls, (lik,) = cfg["layers"]
    assert len(wide) == cfg["data"]["input_dim"] == 13
    assert len(cls) == cfg["data"]["classes"] == lik["num_classes"] == 3
    assert lik == {"name": "Categorical", "num_classes": 3, "link": "softmax"}
    for nd in wide + cls:
        assert nd["name"] == "matern2.5" and nd["length"] == [1.0] and nd["connect"] is None
    assert all(nd["nugget"] == 1e-6 and not nd["nugget_est"] and not nd["scale_est"]
               for nd in wide)
    assert all(nd["nugget"] == 1e-4 and nd["nugget_est"] and nd["scale_est"] for nd in cls)
    assert (cfg["data"]["n"], cfg["vecchia_m"], cfg["ess_burn"]) == (5000, 25, 10)
    assert mix["driver"] == "sem_cat" and (mix["warm_iterations"], mix["chunk"]) == (32, 8)
    assert spec["limits"].keys() == {"ess_ll_gap", "lik_ll_gap", "istep_latent_gap",
                                     "prior_weight_gap", "mstep_nll_gap", "mstep_grad_gap",
                                     "mstep_step_gap"}
    per_layer = {m["name"] for m in core.metrics_of(CELL, "per_layer")}
    assert set(READERS) | {"lik_cands_per_it", "sem_launches_per_it"} <= per_layer
    assert "lik_exact_draw_ms_per_it" not in per_layer
    assert {m["name"] for m in core.metrics_of(CELL, "end_to_end")} == {"setup_s", "sem_it_s"}


def test_data_repeat_for_a_seed_and_hold_every_class():
    """The same seed gives the same inputs and labels; the labels follow
    softmax(f): the most likely class is the label of most points, and
    every class is drawn."""
    spec = core.cell_files(CELL)[1]["data"]
    X1, Y1, f1 = sem_cat.design(np.random.RandomState(5), spec)
    X2, Y2, f2 = sem_cat.design(np.random.RandomState(5), spec)
    assert np.array_equal(X1, X2) and np.array_equal(Y1, Y2) and np.array_equal(f1, f2)
    X3, _, _ = sem_cat.design(np.random.RandomState(6), spec)
    assert not np.array_equal(X1, X3)
    assert X1.shape == (5000, 13) and X1.min() >= 0.0 and X1.max() <= 1.0
    assert np.allclose(f1.mean(0), 0.0, atol=1e-12)
    y = Y1[:, 0].astype(int)
    assert set(np.unique(y)) == {0, 1, 2}
    p = np.exp(f1 - f1.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    assert np.mean(y == p.argmax(1)) > 0.5
    assert abs(np.mean(np.log(p[np.arange(len(y)), y])) - np.mean(np.sum(p * np.log(p), 1))) \
        < 0.05


@pytest.mark.parametrize("fault,number", sem_cat.FAULTS[CELL],
                         ids=lambda v: getattr(v, "__name__", v))
def test_planted_fault_fails(fault, number, monkeypatch):
    """The fault fails the run, and the number meant to catch it reads
    above its limit."""
    with Hooks() as hooks:
        fault(hooks)
        r = run_small(CELL, monkeypatch)
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], r["checks"]


def _recording(extra_spans=(), extra_counters=None):
    """Two iterations in one sem.train."""
    from dgp_tpu_torch import tracing
    ms = 1_000_000
    spans = [(1, None, 1, "sem.train", 0, 100, {"N": 2}), (2, 1, 1, "sem.istep", 0, 60, {}),
             *extra_spans]
    rec = tracing.Recording()
    rec.spans = [tracing.Span(i, p, r, n, a * ms, b * ms, attrs, 0)
                 for i, p, r, n, a, b, attrs in spans]
    rec.counters = {"ess.candidates": 9, "ess.moves": 1, **(extra_counters or {})}
    return rec


@pytest.fixture
def recorded(monkeypatch):
    from dgp_tpu_torch import tracing

    def use(rec):
        monkeypatch.setattr(tracing, "last", lambda: rec)
    return use


def test_readers_read_a_made_up_recording(recorded):
    lik = {"name": "Categorical", "candidates": 9}
    recorded(_recording([(3, 2, 1, "sem.lik", 10, 30, lik),
                         (4, 3, 1, "host_read", 12, 17, {"cause": "x"}),
                         (5, 2, 1, "sem.lik", 40, 45, lik)],
                        {"prior.passes": 92, "prior.columns": 352}))
    assert _reader("lik_host_ms_per_it").read(_Trace(iterations=2)) == pytest.approx(10.0)
    assert _reader("sem_prior_passes_per_it").read(_Trace(iterations=2)) == 46


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_programs_record(name, recorded, monkeypatch):
    """A recording without the span and counter (a tree before them), no
    SEM work, or no `tracing` at all: no reading."""
    recorded(_recording())
    assert _reader(name).read(_Trace(iterations=2)) is None
    assert _reader(name).read(_Trace(points=5, requests=1)) is None
    import dgp_tpu_torch
    monkeypatch.delattr(dgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch.tracing", None)
    assert _reader(name).read(_Trace(iterations=2)) is None


def test_readers_read_what_the_program_recorded(monkeypatch):
    """A unit of the small cell under the program's recording: the prior
    passes of an iteration are 13 batched ones and one a class node a
    sweep, and the Categorical density's evaluations take host time."""
    from dgp_tpu_torch import tracing
    spec, cfg, mix = small_files(CELL, monkeypatch)
    run = core.Run(CELL, spec, cfg, mix, 2**31 + 9, 0.0, 0, "cpu", "float64")
    session = sem_cat.setup(run)
    try:
        with tracing.recording():
            work = session.unit(0)
    finally:
        session.finish()
    sweeps = cfg["ess_burn"] + 1
    assert _reader("sem_prior_passes_per_it").read(_Trace(**work)) == 13 + 3 * sweeps
    ms = _reader("lik_host_ms_per_it").read(_Trace(**work))
    assert np.isfinite(ms) and ms > 0
