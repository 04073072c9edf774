"""The trace's reduction on a made-up event list: the busy time is the
union of the device's intervals (overlaps counted once) over the host's
window; idle gaps are named by the CUDA runtime call the host was in."""
import pytest

from benchmark.harness import trace as tr


class _Counter:
    entries, calls = {}, {}


def test_busy_is_the_union_of_device_intervals():
    events = [("k1", True, 100.0, 300.0),
              ("k2", True, 200.0, 400.0),          # overlaps k1
              ("Memcpy DtoH (Device -> Pageable)", True, 600.0, 650.0),
              ("k1", True, 900.0, 1000.0),
              ("cudaLaunchKernel", False, 90.0, 95.0),
              ("cudaMemcpyAsync", False, 410.0, 590.0),
              ("cudaDeviceSynchronize", False, 1000.0, 1001.0)]
    t = tr.Trace(events, {"iterations": 2}, _Counter(), 1e-3)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((300 + 50 + 100) / 1e6)
    assert t.n_kernels == 3 and t.n_dtoh == 1 and t.n_device_syncs == 1
    assert t.kernel_seconds("k1") == pytest.approx(300 / 1e6)
    assert t.breakdown["idle_gaps"] == [
        ["host: outside the CUDA runtime", pytest.approx(250 / 1e6)],
        ["host: cudaMemcpyAsync", pytest.approx(200 / 1e6)]]
    assert t.breakdown["device_ops"][0][0] == "k1"


def test_no_device_operation_is_an_error():
    with pytest.raises(RuntimeError):
        tr.Trace([("cudaLaunchKernel", False, 1.0, 2.0)], {}, _Counter(), 1e-5)
