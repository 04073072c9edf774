"""The linked system's prediction as a share of the card's float64 peak:
the operations of every Vecchia kriging, Vecchia linked-moment and dense
linked-moment call in the traced window over its seconds."""


def read(trace):
    return trace.mfu_pct("predict", "points")
