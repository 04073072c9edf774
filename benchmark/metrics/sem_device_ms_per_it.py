"""Device-busy milliseconds per SEM iteration in the traced window (the
union of its kernel, copy and set intervals over the iterations): the
device's share of an iteration, which the host's pace does not move."""


def read(trace):
    it = trace.work.get("iterations")
    return 1e3 * trace.busy_s / it if it else None
