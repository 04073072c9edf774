"""Ancestral passes of the Vecchia prior draws per SEM iteration in the
traced window: the program's counter prior.passes over the window's
iterations; nothing where the recording holds no such counter."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    if rec is None or "prior.passes" not in rec.counters:
        return None
    return rec.counters["prior.passes"] / it
