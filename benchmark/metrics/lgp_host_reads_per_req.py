"""Reads from the device per lgp.predict request in the traced window, as
the program counts them (the counters host_reads.*)."""
from benchmark.metrics import _program


def read(trace):
    rec, req = _program.lgp(trace)
    return None if rec is None else _program.host_reads(rec) / req
