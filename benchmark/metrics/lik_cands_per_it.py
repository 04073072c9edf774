"""States a likelihood node's log-likelihood evaluated per SEM iteration in
the traced window: the program's counter lik.candidates over the window's
iterations; nothing where the recording holds no such counter."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    if rec is None or "lik.candidates" not in rec.counters:
        return None
    return rec.counters["lik.candidates"] / it
