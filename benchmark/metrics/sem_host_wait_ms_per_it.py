"""Milliseconds per SEM iteration that the host waits in reads from the
device (the program's host_read spans) in the traced window."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    return None if rec is None else _program.span_ms(rec, "host_read") / it
