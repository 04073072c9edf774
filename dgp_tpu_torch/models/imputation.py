"""Imputer facade; the counterpart of `dgp_tpu/models/imputation.py`.

Sampling runs through the ESS-within-Gibbs engine (models/compiled.py) on
the imputer's device and writes results back into the object graph.
"""
import numpy as np

from .. import config, rng
from .compiled import CompiledDGP


class imputer:
    """ESS-within-Gibbs imputation of a DGP structure on ``device``
    (default: the card)."""

    def __init__(self, all_layer, block=True, device=None):
        self.all_layer = all_layer
        self.block = block
        self.device = config.resolve_device(device)
        self._compiled = None

    def _engine(self):
        if self._compiled is None:
            self._compiled = CompiledDGP(self.all_layer, self.block, self.device)
        return self._compiled

    def invalidate(self):
        """Drop the engine (call after structural or data changes)."""
        self._compiled = None

    def sample(self, burnin=0):
        """(burnin+1) ESS-within-Gibbs sweeps over all hidden layers."""
        c = self._engine()
        state = c.get_state()
        state = c.sample(state, rng.next_generator(self.device),
                         rng.next_generator('cpu'), int(burnin))
        c.set_state(state)

    def key_stats(self):
        """Cache every GP node's dense prediction statistics (Rinv,
        Rinv_y)."""
        for layer in self.all_layer:
            for node in layer:
                if node.type == 'gp':
                    node.compute_stats()

    def update_ord_nn(self):
        """Refresh Vecchia orderings/neighbours for all GP nodes, reusing the
        structure across nodes with identical wiring."""
        for layer in self.all_layer:
            for k, node in enumerate(layer):
                if node.type != 'gp':
                    continue
                pointer = node.imp_NNarray is not None
                found = None
                for j in range(k):
                    other = layer[j]
                    if other.type != 'gp':
                        continue
                    same_wiring = (np.array_equal(node.input_dim, other.input_dim)
                                   and np.array_equal(node.connect, other.connect))
                    if same_wiring and (
                        (len(node.length) == 1 and len(other.length) == 1)
                        or np.array_equal(node.length, other.length)
                    ):
                        found = other
                        break
                if found is not None:
                    node.ord_nn(ord=found.ord.copy(), NNarray=found.NNarray.copy(),
                                pointer=pointer, device=self.device)
                else:
                    node.ord_nn(pointer=pointer, device=self.device)
