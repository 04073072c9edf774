"""The I-step's own host milliseconds per SEM iteration in the traced
window: its sem.istep spans less the host_read spans inside them.  This
holds the host's enqueueing (the prior draw's ancestral pass, the ESS
rounds) and the waits of its uploads from pageable memory, which
synchronise the stream but read nothing back."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    if rec is None:
        return None
    return (_program.span_ms(rec, "sem.istep")
            - _program.span_ms(rec, "host_read", under="sem.istep")) / it
