"""The per-layer metrics that read the program's own record of the traced
window (`dgp_tpu_torch.tracing`): known figures from a made-up recording,
an error where the window did work and the recording is empty or does not
account for it, no reading where the program records nothing, and the
readers over a recording the program made."""
import sys

import numpy as np
import pytest

from benchmark.harness import core
from conftest import ROOT

SEM = ("sem_host_reads_per_it", "sem_ess_cands_per_move", "sem_host_wait_ms_per_it",
       "sem_istep_host_ms_per_it", "sem_mstep_host_ms_per_it")
LGP = ("lgp_host_reads_per_req", "lgp_host_wait_ms_per_req")


def _reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


class _Trace:
    def __init__(self, **work):
        self.work = work


def _recording(spans, counters):
    from dgp_tpu_torch import tracing
    rec = tracing.Recording()
    ms = 1_000_000
    rec.spans = [tracing.Span(i, p, r, n, a * ms, b * ms, attrs, 0)
                 for i, p, r, n, a, b, attrs in spans]
    rec.counters = dict(counters)
    return rec


def _sem_recording():
    """Two iterations in one sem.train: two I-steps with a read in an ESS
    round each, two M-steps, and the finite check's read."""
    return _recording([
        (1, None, 1, "sem.train", 0, 100, {"N": 2}),
        (2, 1, 1, "sem.istep", 0, 40, {}),
        (3, 2, 1, "sem.ess.round", 5, 30, {}),
        (4, 3, 1, "host_read", 10, 20, {"cause": "ess_round"}),
        (5, 1, 1, "sem.mstep", 40, 50, {}),
        (6, 1, 1, "sem.istep", 50, 70, {}),
        (7, 6, 1, "host_read", 55, 60, {"cause": "ess_round"}),
        (8, 1, 1, "sem.mstep", 70, 80, {}),
        (9, 1, 1, "host_read", 90, 95, {"cause": "finite_check"}),
    ], {"host_reads.ess_round": 2, "host_reads.finite_check": 1, "ess.candidates": 10,
        "ess.moves": 4, "ess.rounds": 2})


def _lgp_recording():
    return _recording([
        (1, None, 1, "lgp.predict", 0, 20, {}),
        (2, 1, 1, "predict.container", 0, 10, {"kind": "gp", "layer": 0}),
        (3, 2, 1, "host_read", 2, 5, {"cause": "predict_out"}),
        (4, None, 4, "lgp.predict", 30, 50, {}),
        (5, 4, 4, "host_read", 40, 45, {"cause": "predict_out"}),
    ], {"host_reads.predict_out": 6})


@pytest.fixture
def recorded(monkeypatch):
    from dgp_tpu_torch import tracing

    def use(rec):
        monkeypatch.setattr(tracing, "last", lambda: rec)
    return use


@pytest.mark.parametrize("name,value", [
    ("sem_host_reads_per_it", 1.5), ("sem_ess_cands_per_move", 2.5),
    ("sem_host_wait_ms_per_it", 10.0), ("sem_istep_host_ms_per_it", 22.5),
    ("sem_mstep_host_ms_per_it", 10.0)])
def test_sem_readers_read_a_made_up_recording(name, value, recorded):
    recorded(_sem_recording())
    assert _reader(name).read(_Trace(iterations=2)) == pytest.approx(value)
    assert _reader(name).read(_Trace(points=5, requests=1)) is None


@pytest.mark.parametrize("name,value", [("lgp_host_reads_per_req", 3.0),
                                        ("lgp_host_wait_ms_per_req", 4.0)])
def test_lgp_readers_read_a_made_up_recording(name, value, recorded):
    recorded(_lgp_recording())
    assert _reader(name).read(_Trace(points=500, requests=2)) == pytest.approx(value)
    assert _reader(name).read(_Trace(iterations=2)) is None


@pytest.mark.parametrize("name", SEM + LGP)
def test_readers_raise_on_an_empty_or_mismatched_recording(name, recorded):
    work = {"iterations": 2} if name in SEM else {"points": 500, "requests": 2}
    recorded(_recording([], {}))
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader(name).read(_Trace(**work))
    recorded(None)
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader(name).read(_Trace(**work))
    recorded(_sem_recording() if name in SEM else _lgp_recording())
    more = {k: 2 * v for k, v in work.items()}
    with pytest.raises(RuntimeError):
        _reader(name).read(_Trace(**more))


@pytest.mark.parametrize("name", SEM + LGP)
def test_readers_give_nothing_where_the_program_records_nothing(name, monkeypatch):
    import dgp_tpu_torch
    monkeypatch.delattr(dgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch.tracing", None)
    work = {"iterations": 2} if name in SEM else {"points": 500, "requests": 2}
    assert _reader(name).read(_Trace(**work)) is None


def test_readers_read_what_the_program_recorded():
    """A small Vecchia DGP's train(N=3): every SEM reader gives a finite,
    positive reading, and the reads are the program's host_read spans."""
    import dgp_tpu_torch as dt
    from dgp_tpu_torch import tracing
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (100, 1))
    Y = np.sin(4 * X) + 0.05 * rs.randn(100, 1)
    k = dt.kernel
    layers = dt.combine([k(length=np.array([0.5]), name='sexp')],
                        [k(length=np.array([0.5]), name='sexp', scale_est=True,
                           nugget_est=True, connect=np.arange(1))])
    dt.nb_seed(0)
    m = dt.dgp(X, Y, layers, vecchia=True, m=10, device='cpu')
    with tracing.recording() as rec:
        m.train(N=3, chunk_size=3, disable=True)
    reads = sum(v for k_, v in rec.counters.items() if k_.startswith("host_reads."))
    assert reads == sum(s.name == "host_read" for s in rec.spans)
    for name in SEM:
        v = _reader(name).read(_Trace(iterations=3))
        assert np.isfinite(v) and v > 0, name
    assert _reader("sem_host_reads_per_it").read(_Trace(iterations=3)) == reads / 3
