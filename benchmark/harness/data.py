"""The configurations' test functions, by the name a configuration gives.

``bench_func`` is the step function of dgpsi's `vecchia_SI.ipynb` demo
(the composition of ``linked_f2`` after ``linked_f1``);
``linked_f1`` and ``linked_f2`` are the two computer models of its
`model_linking.ipynb` demo.
"""
import numpy as np


def linked_f1(x):
    return (np.sin(7.5 * x) + 1) / 2


def linked_f2(x):
    u = 2 * (2 * x - 1)
    return 2 / 3 * np.sin(u) + 4 / 3 * np.exp(-30 * u ** 2) - 1 / 3


def bench_func(x):
    return linked_f2(linked_f1(x))


FUNCTIONS = {"bench_func": bench_func, "linked_f1": linked_f1, "linked_f2": linked_f2}


def design(rng, spec):
    """Inputs and noisy outputs of one model of a configuration: ``n``
    points uniform on [lo, hi]^d, ``function`` plus ``noise`` standard
    normal noise, in that order from ``rng``."""
    lo, hi = spec["domain"]
    X = lo + (hi - lo) * rng.rand(spec["n"], spec["input_dim"])
    Y = FUNCTIONS[spec["function"]](X) + spec["noise"] * rng.randn(spec["n"], 1)
    return X, Y
