"""lgp_k6_launches_per_req, the per-layer metric that reads how many K6
launches (`kernel.launches.K6` of `dgp_tpu_torch.tracing`) the program
makes per lgp.predict request: no reading without a recording or where the
program has no K6, 0 where it counts no K6 launch, launches per request on
a made-up recording, an error where the window did work and the recording
is empty or does not account for it, and 0 on the program's own recording
of a small Vecchia system on the CPU, where no kernel launches."""
import sys

import numpy as np
import pytest

from benchmark.harness import core
from conftest import ROOT

NAME = "lgp_k6_launches_per_req"


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
    ({"host_reads.predict_out": 60}, 0.0),
    ({"kernel.launches.K5": 20, "kernel.launches.K6": 40,
      "kernel.launches.K6@cuda:0": 40}, 20.0),
    ({"kernel.launches.K6": 43}, 21.5),
])
def test_reader_reads_a_made_up_recording(counters, value, recorded):
    recorded(_recording(counters))
    assert _reader().read(_Trace(points=500, requests=2)) == pytest.approx(value)
    assert _reader().read(_Trace(iterations=2)) is None


def test_reader_gives_nothing_where_the_program_has_no_k6(recorded, monkeypatch):
    from dgp_tpu_torch.ops import cuda_vecchia
    recorded(_recording({"kernel.launches.K5": 20}))
    launch_id = {k: v for k, v in cuda_vecchia.LAUNCH_ID.items() if v != "K6"}
    monkeypatch.setattr(cuda_vecchia, "LAUNCH_ID", launch_id)
    assert _reader().read(_Trace(points=500, requests=2)) is None


def test_reader_raises_on_an_empty_or_mismatched_recording(recorded):
    from dgp_tpu_torch import tracing
    recorded(tracing.Recording())
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader().read(_Trace(points=500, requests=2))
    recorded(None)
    with pytest.raises(RuntimeError, match="recorded no span"):
        _reader().read(_Trace(points=500, requests=2))
    recorded(_recording({"kernel.launches.K6": 4}))
    with pytest.raises(RuntimeError):
        _reader().read(_Trace(points=1000, requests=4))


def test_reader_gives_nothing_where_the_program_records_nothing(monkeypatch):
    import dgp_tpu_torch
    monkeypatch.delattr(dgp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch.tracing", None)
    assert _reader().read(_Trace(points=500, requests=2)) is None


def test_reader_reads_what_the_program_recorded():
    """A small Vecchia GP -> GP system on the CPU: its predictions run the
    plain versions, so the reading is 0."""
    import dgp_tpu_torch as dt
    from dgp_tpu_torch import tracing
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (40, 1))
    kw = dict(vecchia=True, m=10, device='cpu')
    g1 = dt.gp(X, np.sin(3 * X), dt.kernel(length=np.array([0.5]), nugget=1e-3), **kw)
    g2 = dt.gp(X, np.cos(2 * X), dt.kernel(length=np.array([0.5]), nugget=1e-3), **kw)
    system = dt.lgp([[dt.container(g1.export(), local_input_idx=np.array([0]), device='cpu')],
                     [dt.container(g2.export(), local_input_idx=np.array([0]), device='cpu')]],
                    device='cpu')
    x = np.linspace(-0.9, 0.9, 11)[:, None]
    with tracing.recording():
        system.predict(x, m=12)
    assert _reader().read(_Trace(points=11, requests=1)) == 0.0
