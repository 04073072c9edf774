"""Host milliseconds per SEM iteration in the exact Gibbs draws of a Hetero
node's mean in the traced window: the program's sem.exact_draw spans less
the host_read spans inside them; nothing where the recording holds no
such span."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    if rec is None or not any(s.name == "sem.exact_draw" for s in rec.spans):
        return None
    return (_program.span_ms(rec, "sem.exact_draw")
            - _program.span_ms(rec, "host_read", under="sem.exact_draw")) / it
