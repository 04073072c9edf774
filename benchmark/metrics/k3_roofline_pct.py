"""K3's least time on the card (counts/ops.py, from each call's shapes) over
its device time in the traced window, in percent; nothing where the window
made no K3 call."""


def read(trace):
    return trace.roofline_pct("K3")
