"""Vecchia integration with the kernel class: ordering and neighbour
construction (reference kernel_class.ord_nn); the counterpart of the
ordering part of `dgp_tpu/vecchia/api.py`.  Not ported yet: the
node-level M-step and prediction entry points (the SEM M-step lives in
models/mstep.py) and the self-excluded neighbour sets of the Hetero exact
posterior (``pointer``).
"""
import numpy as np

from . import nn as nnmod


def ord_nn(node, ord=None, NNarray=None, device=None):
    """Set the Vecchia ordering and neighbour structure on a GP node."""
    if ord is None:
        if node.ord_fun is None:
            node.ord = np.random.permutation(node.input.shape[0])
        else:
            node.ord = node.ord_fun(_scaled_input(node))
    else:
        node.ord = np.asarray(ord)
    node.rev_ord = np.argsort(node.ord)
    if NNarray is None:
        X = _scaled_input(node)
        node.NNarray = nnmod.nn(X[node.ord], node.m, device=device)
    else:
        node.NNarray = np.asarray(NNarray)


def _scaled_input(node):
    if node.global_input is not None:
        X = np.concatenate((node.input, node.global_input), axis=1)
    else:
        X = node.input
    return X / node.length
