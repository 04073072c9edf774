"""lgp_operand_mb_per_req, the per-layer metric that reads the bytes of
training-side prediction operands the program uploads per lgp.predict
request (the `pred_ops.*` counters of `dgp_tpu_torch.tracing`): no reading
on a recording without those counters, MB per request on a made-up
recording, an error where the window did work and the recording is empty
or does not account for it, and the program's own recording of a small
linked system."""
import sys

import numpy as np
import pytest

from benchmark.harness import core
from conftest import ROOT

NAME = "lgp_operand_mb_per_req"


def _reader():
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{NAME}.py", f"metric_{NAME}")


class _Trace:
    def __init__(self, **work):
        self.work = work


def _recording(counters, requests=2):
    """``requests`` lgp.predict roots of 10 ms each and ``counters``."""
    from dgp_tpu_torch import tracing
    rec = tracing.Recording()
    ms = 1_000_000
    rec.spans = [tracing.Span(i + 1, None, i + 1, "lgp.predict", 20 * i * ms,
                              (20 * i + 10) * ms, {}, 0) for i in range(requests)]
    rec.counters = dict(counters)
    return rec


@pytest.fixture
def recorded(monkeypatch):
    from dgp_tpu_torch import tracing

    def use(rec):
        monkeypatch.setattr(tracing, "last", lambda: rec)
    return use


@pytest.mark.parametrize("counters,value", [
    ({"host_reads.predict_out": 6}, None),
    ({"pred_ops.kept": 40}, 0.0),
    ({"pred_ops.made": 3, "pred_ops.kept": 37, "pred_ops.upload_bytes": 64_000_000}, 32.0),
])
def test_reader_reads_a_made_up_recording(counters, value, recorded):
    recorded(_recording(counters))
    got = _reader().read(_Trace(points=500, requests=2))
    assert got == (None if value is None else pytest.approx(value))
    assert _reader().read(_Trace(iterations=2)) is None


def test_reader_raises_on_an_empty_or_mismatched_recording(recorded):
    from dgp_tpu_torch import tracing
    recorded(tracing.Recording())
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader().read(_Trace(points=500, requests=2))
    recorded(None)
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader().read(_Trace(points=500, requests=2))
    recorded(_recording({"pred_ops.kept": 4}))
    with pytest.raises(RuntimeError):
        _reader().read(_Trace(points=1000, requests=4))


def test_reader_gives_nothing_where_the_program_records_nothing(monkeypatch):
    import dgp_tpu_torch
    monkeypatch.delattr(dgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch.tracing", None)
    assert _reader().read(_Trace(points=500, requests=2)) is None


def test_reader_reads_what_the_program_recorded():
    """A small GP -> GP system on the CPU: the second request keeps every
    operand and uploads nothing, so the reading is 0."""
    import dgp_tpu_torch as dt
    from dgp_tpu_torch import tracing
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (40, 1))
    g1 = dt.gp(X, np.sin(3 * X), dt.kernel(length=np.array([0.5]), nugget=1e-3), device='cpu')
    g2 = dt.gp(X, np.cos(2 * X), dt.kernel(length=np.array([0.5]), nugget=1e-3), device='cpu')
    system = dt.lgp([[dt.container(g1.export(), local_input_idx=np.array([0]), device='cpu')],
                     [dt.container(g2.export(), local_input_idx=np.array([0]), device='cpu')]],
                    device='cpu')
    x = np.linspace(-0.9, 0.9, 11)[:, None]
    system.predict(x)
    with tracing.recording() as rec:
        system.predict(x)
    assert rec.counters.get("pred_ops.kept", 0) > 0
    assert rec.counters.get("pred_ops.made", 0) == 0
    assert _reader().read(_Trace(points=11, requests=1)) == 0.0
