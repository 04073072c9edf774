"""The whole SEM step's share of the card's float64 peak: the operations of
every K1-K4 call in the traced window (counts/ops.py) over its seconds."""


def read(trace):
    return trace.mfu_pct("sem", "iterations")
