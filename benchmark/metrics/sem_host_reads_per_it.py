"""Reads from the device per SEM iteration in the traced window, as the
program counts them (`tracing.to_host`: the counters host_reads.*): each
stops the host until the card has caught up."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    return None if rec is None else _program.host_reads(rec) / it
