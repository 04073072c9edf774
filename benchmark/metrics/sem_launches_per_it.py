"""Device kernel launches per SEM iteration in the traced window, counted
from the profiler's kernel records."""


def read(trace):
    it = trace.work.get("iterations")
    return trace.n_kernels / it if it else None
