"""MB (1e6 bytes) of training-side operands that lgp.predict uploads to the
device per request in the traced window, as the program counts them
(pred_ops.upload_bytes).  A program that counts no pred_ops.* gives no
reading."""
from benchmark.metrics import _program


def read(trace):
    rec, req = _program.lgp(trace)
    if rec is None or not any(k.startswith("pred_ops.") for k in rec.counters):
        return None
    return rec.counters.get("pred_ops.upload_bytes", 0) / 1e6 / req
