"""Host milliseconds per SEM iteration in the evaluations of a likelihood
node's log-likelihood in the traced window: the program's sem.lik spans
less the host_read spans inside them; nothing where the recording holds no
such span."""
from benchmark.metrics import _program


def read(trace):
    rec, it = _program.sem(trace)
    if rec is None or not any(s.name == "sem.lik" for s in rec.spans):
        return None
    return (_program.span_ms(rec, "sem.lik")
            - _program.span_ms(rec, "host_read", under="sem.lik")) / it
