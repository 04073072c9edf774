"""Milliseconds per lgp.predict request that the host waits in reads from
the device (the program's host_read spans under lgp.predict) in the
traced window."""
from benchmark.metrics import _program


def read(trace):
    rec, req = _program.lgp(trace)
    return None if rec is None else _program.span_ms(rec, "host_read", under="lgp.predict") / req
