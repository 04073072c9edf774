"""The heteroskedastic DGP's cell, `dgp3_hetero_n2000.sem`, at a size the CPU
holds: its data, its planted faults (`traffic/sem_lik.py`'s ``FAULTS``),
and the readers of the likelihood layer's span and counter.

`conftest.small_files` sizes every cell whose name does not begin with
``vsi`` as the linked system; this module hands it this cell's small
files (n = 200, m = 10, 2-iteration chunks after 6), so that the cases of
`test_bench_control.py` and `test_bench_layout.py` over every cell run it
too when the whole directory is collected."""
import copy
import sys

import numpy as np
import pytest

import conftest
from benchmark.harness import core, data
from benchmark.harness.hooks import Hooks
from benchmark.traffic import sem_lik
from conftest import ROOT, run_small

CELL = "dgp3_hetero_n2000.sem"
LIK = ("lik_exact_draw_ms_per_it", "lik_cands_per_it")
_small_files = conftest.small_files


def small_files(cell, monkeypatch):
    if cell != CELL:
        return _small_files(cell, monkeypatch)
    spec, cfg, mix = (copy.deepcopy(x) for x in core.cell_files(cell))
    spec.update(check_units=2, check_from=3)
    cfg["data"]["n"] = 200
    cfg["vecchia_m"] = 10
    mix.update(warm_iterations=6, chunk=2)
    return spec, cfg, mix


conftest.small_files = small_files


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


class _Trace:
    def __init__(self, **work):
        self.work = work


def test_data_repeat_for_a_seed_and_the_noise_grows_with_x():
    spec = dict(core.cell_files(CELL)[1]["data"], n=4000)
    X1, Y1 = sem_lik.design(np.random.RandomState(5), spec)
    X2, Y2 = sem_lik.design(np.random.RandomState(5), spec)
    assert np.array_equal(X1, X2) and np.array_equal(Y1, Y2)
    r = (Y1 - data.bench_func(X1))[:, 0]
    lo, hi = r[X1[:, 0] < -0.5], r[X1[:, 0] > 0.5]
    assert 0.02 < lo.std() < 0.035 < 0.08 < hi.std() < 0.1


@pytest.mark.parametrize("fault,number", sem_lik.FAULTS[CELL],
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
    """One iteration in one sem.train, with an exact draw holding a read
    when ``extra_spans`` brings it."""
    from dgp_tpu_torch import tracing
    ms = 1_000_000
    spans = [(1, None, 1, "sem.train", 0, 100, {"N": 1}), (2, 1, 1, "sem.istep", 0, 60, {}),
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


def test_lik_readers_read_a_made_up_recording(recorded):
    recorded(_recording([(3, 2, 1, "sem.exact_draw", 10, 30, {"layer": 1, "kind": "vecchia"}),
                         (4, 3, 1, "host_read", 12, 17, {"cause": "x"}),
                         (5, 2, 1, "sem.exact_draw", 40, 45, {"layer": 1, "kind": "vecchia"})],
                        {"lik.candidates": 90, "lik.evals": 10}))
    assert _reader("lik_exact_draw_ms_per_it").read(_Trace(iterations=1)) == pytest.approx(20.0)
    assert _reader("lik_cands_per_it").read(_Trace(iterations=1)) == 90


@pytest.mark.parametrize("name", LIK)
def test_lik_readers_give_nothing_without_the_layers_record(name, recorded, monkeypatch):
    """A recording without the span and counter (a tree before them), no
    SEM work, or no `tracing` at all: no reading."""
    recorded(_recording())
    assert _reader(name).read(_Trace(iterations=1)) is None
    assert _reader(name).read(_Trace(points=5, requests=1)) is None
    import dgp_tpu_torch
    monkeypatch.delattr(dgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch.tracing", None)
    assert _reader(name).read(_Trace(iterations=1)) is None


def test_lik_readers_read_what_the_program_recorded():
    """A small Hetero Vecchia DGP's train(N=2): one exact draw a sweep, and
    likelihood candidates above one a sweep."""
    import dgp_tpu_torch as dt
    from dgp_tpu_torch import tracing
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (80, 1))
    Y = np.sin(3 * X) + 0.05 * np.exp(0.8 * X) * rs.randn(80, 1)
    k = dt.kernel
    layers = dt.combine([k(length=np.array([0.5]), name="sexp")],
                        [k(length=np.array([0.2]), name="sexp", scale_est=True,
                           connect=np.arange(1)) for _ in range(2)],
                        [dt.Hetero()])
    dt.nb_seed(0)
    m = dt.dgp(X, Y, layers, vecchia=True, m=8, device="cpu")
    with tracing.recording() as rec:
        m.train(N=2, ess_burn=3, chunk_size=2, disable=True)
    ms = _reader("lik_exact_draw_ms_per_it").read(_Trace(iterations=2))
    cands = _reader("lik_cands_per_it").read(_Trace(iterations=2))
    assert np.isfinite(ms) and ms > 0
    assert cands == rec.counters["lik.candidates"] / 2 and cands > 4
