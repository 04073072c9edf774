"""The M-step's host milliseconds per SEM iteration in the traced window
(its sem.mstep spans): it reads nothing back, so this is the time to
enqueue it, with the waits of its uploads from pageable memory, which
synchronise the stream."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    return None if rec is None else _program.span_ms(rec, "sem.mstep") / it
