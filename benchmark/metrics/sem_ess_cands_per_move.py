"""ESS states evaluated per accepted move in the traced SEM window: the
program's counters ess.candidates (each round's candidates, and the
current state in a transition's first round) over ess.moves (transitions
that accepted a candidate)."""
from benchmark.metrics import _program


def read(trace):
    rec, _ = _program.sem(trace)
    if rec is None:
        return None
    moves = rec.counters.get("ess.moves", 0)
    if not moves:
        raise RuntimeError("the window's ESS accepted no move")
    return rec.counters.get("ess.candidates", 0) / moves
