"""Carry a DGP structure across from plain data (for example from the JAX
package's node attributes, which are numpy already, or from a JSON file).

The input is a list of layers, each a list of per-node dicts of numpy
arrays, numbers and strings with the keys of `NODE_KEYS`; a missing key
leaves the node's default (so a dict of hyper-parameters alone gives a
node that `dgp` can initialise).  The training traces (``para_path``,
``R2``) come across too, so that a model trained in one package can be
estimated by, or continue training in, the other.
"""
import numpy as np

from .models.node import kernel

#: node attributes carried across
NODE_KEYS = ('name', 'scale', 'length', 'nugget', 'nugget_est', 'scale_est',
             'input_dim', 'connect', 'input', 'global_input', 'output', 'ord',
             'NNarray', 'm', 'para_path', 'R2')
_ARRAYS = ('input', 'global_input', 'output', 'para_path', 'R2')


def node_from_numpy(d):
    """One `kernel` from a dict of its attributes."""
    node = kernel(length=np.asarray(d['length']), scale=d.get('scale', 1.0),
                  nugget=d.get('nugget', 1e-6), name=d.get('name', 'sexp'),
                  nugget_est=bool(d.get('nugget_est', False)),
                  scale_est=bool(d.get('scale_est', False)),
                  input_dim=d.get('input_dim'), connect=d.get('connect'))
    dt = node.length.dtype
    for key in _ARRAYS:
        if d.get(key) is not None:
            setattr(node, key, np.asarray(d[key], dt))
    if d.get('ord') is not None:
        node.ord = np.asarray(d['ord'], np.int64)
        node.rev_ord = np.argsort(node.ord)
        node.NNarray = np.asarray(d['NNarray'], np.int64)
        node.vecch = True
    if d.get('m') is not None:
        node.m = int(d['m'])
    if node.input is not None:
        node.D = node.input.shape[1] + (0 if node.connect is None else len(node.connect))
    if node.para_path is None:
        node.para_path = np.atleast_2d(np.concatenate((node.scale, node.length,
                                                       node.nugget)))
    return node


def layers_from_numpy(spec):
    """The port's ``all_layer`` (list of layers of `kernel`s) from a list of
    layers of per-node dicts."""
    return [[node_from_numpy(d) for d in layer] for layer in spec]


def layers_to_numpy(all_layer):
    """The inverse of `layers_from_numpy` for any structure whose nodes
    carry the `NODE_KEYS` attributes (either package's)."""
    return [[{k: getattr(node, k, None) for k in NODE_KEYS} for node in layer]
            for layer in all_layer]
