"""Launches of K6, a Vecchia node's prediction in one hand-written kernel,
per lgp.predict request in the traced window, as the program counts them
(kernel.launches.K6): how often the mechanism engages, 10 kriging and 10
Vecchia linked-moment calls a request of lgp_n2000.predict.  A program
without K6 (no "K6" among `cuda_vecchia.LAUNCH_ID`'s kernels) gives no
reading; one with it that launched none reads 0."""
from benchmark.metrics import _program


def _has_k6():
    try:
        from dgp_tpu_torch.ops import cuda_vecchia
    except ImportError:
        return False
    return "K6" in getattr(cuda_vecchia, "LAUNCH_ID", {}).values()


def read(trace):
    rec, req = _program.lgp(trace)
    if rec is None or not _has_k6():
        return None
    return rec.counters.get("kernel.launches.K6", 0) / req
