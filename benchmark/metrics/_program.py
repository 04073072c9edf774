"""Shared by the per-layer metrics that read the program's own record of
the traced window (not a metric itself): the recording of
`dgp_tpu_torch.tracing`, which the program keeps while the profiler is on,
checked against the work the window completed.

A tree whose program records nothing (no `dgp_tpu_torch.tracing`) gives
no reading.  Where the window did work and the recording holds no span, or
its root spans do not account for the window's units, the reader raises.
"""


def _window(trace, work_key):
    if not trace.work.get(work_key):
        return None
    try:
        from dgp_tpu_torch import tracing
    except ImportError:
        return None
    rec = tracing.last()
    if rec is None or not rec.spans:
        raise RuntimeError(f"the window did {work_key} but the program recorded no span")
    return rec


def _roots(rec, name):
    roots = [s for s in rec.spans if s.parent is None]
    if any(s.name != name for s in roots):
        raise RuntimeError(f"the recording holds roots other than {name}: "
                           f"{sorted({s.name for s in roots} - {name})}")
    return roots


def sem(trace):
    """(recording, iterations) of a SEM window, or (None, None): the
    ``N`` of its ``sem.train`` roots sum to the window's iterations."""
    rec = _window(trace, "iterations")
    if rec is None:
        return None, None
    it = trace.work["iterations"]
    n = sum(s.attrs["N"] for s in _roots(rec, "sem.train"))
    if n != it:
        raise RuntimeError(f"the recording's sem.train spans hold {n} iterations, "
                           f"the window {it}")
    return rec, it


def lgp(trace):
    """(recording, requests) of an lgp window, or (None, None): one
    ``lgp.predict`` root per request."""
    rec = _window(trace, "requests")
    if rec is None:
        return None, None
    req = trace.work["requests"]
    n = len(_roots(rec, "lgp.predict"))
    if n != req:
        raise RuntimeError(f"the recording holds {n} lgp.predict spans, the window "
                           f"{req} requests")
    return rec, req


def host_reads(rec):
    """The window's reads from the device (the counters host_reads.*)."""
    return sum(v for k, v in rec.counters.items() if k.startswith("host_reads."))


def span_ms(rec, name, under=None):
    """Milliseconds in the spans ``name``, those with an enclosing span
    ``under`` alone where it is given."""
    by_id = {s.id: s for s in rec.spans}

    def inside(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == under:
                return True
            p = by_id.get(p.parent)
        return False
    return sum(s.end_ns - s.start_ns for s in rec.spans
               if s.name == name and (under is None or inside(s))) / 1e6
