"""The share of the traced prediction window in which no operation ran on
the device: 100 less the union of its kernel, copy and set intervals."""


def read(trace):
    if not trace.work.get("points"):
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
