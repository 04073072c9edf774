"""The DGP emulator's prediction as a share of the card's float64 peak: the
operations of every Vecchia kriging and linked-moment call (every query
point, imputation and node) in the traced window over its seconds."""


def read(trace):
    return trace.mfu_pct("predict", "points")
