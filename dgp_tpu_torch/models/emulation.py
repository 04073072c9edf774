"""DGP emulator: multi-imputation predictions from a trained DGP; the
counterpart of `dgp_tpu/models/emulation.py`.

The constructor draws N imputations of the latent layers (on the
emulator's device) and stores them; `predict` propagates mean and variance
layer by layer through each imputation (models/ensemble.py) and aggregates
them as a Gaussian mixture.  Ported: the constructor for dense and Vecchia
structures and ``predict(method='mean_var')``; the other methods of the JAX
emulator (sampling, LOO, nllik, design metrics) are not ported yet (O6).
"""
import copy

import numpy as np

from .. import config
from .imputation import imputer
from .ensemble import CompiledEnsemble


class emulator:
    """Predictor for a trained DGP (emulation.py:14)."""

    def __init__(self, all_layer, N=10, block=True, device=None):
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        self.vecch = bool(self.all_layer[0][0].vecch)
        self.block = block
        self.device = config.resolve_device(device)
        self.imp = imputer(self.all_layer, block, self.device)
        if self.vecch:
            self.imp.update_ord_nn()
            self.imp.sample(burnin=20)
        else:
            self.imp.sample(burnin=50)
        self.all_layer_set = []
        for _ in range(N):
            if self.vecch:
                self.imp.update_ord_nn()
            self.imp.sample()
            self.all_layer_set.append(copy.deepcopy(self.all_layer))
        self._ens = None

    @classmethod
    def from_imputations(cls, all_layer_set, device=None):
        """An emulator over an existing imputation set (for example one
        carried across from the JAX package with `interop`), without
        drawing new imputations."""
        self = cls.__new__(cls)
        self.all_layer = all_layer_set[0]
        self.n_layer = len(self.all_layer)
        self.vecch = bool(self.all_layer[0][0].vecch)
        self.block = True
        self.device = config.resolve_device(device)
        self.imp = None
        self.all_layer_set = list(all_layer_set)
        self._ens = None
        return self

    def predict(self, x, method='mean_var', m=50):
        """Mean and variance at x (M, d) through the imputation ensemble:
        the Gaussian mixture's mean and variance, each (M, n_out)."""
        if method != 'mean_var':
            raise NotImplementedError(
                f"predict(method={method!r}) is not ported to dgp_tpu_torch yet "
                "(ROADMAP.md, O6)")
        if x.ndim == 1:
            raise Exception('The testing input has to be a numpy 2d-array')
        if self._ens is None:
            self._ens = CompiledEnsemble(self.all_layer_set, self.device)
        loo = any(node.loo_state for layer in self.all_layer_set[0] for node in layer)
        means, vars_ = self._ens.propagate(np.asarray(x, config.np_dtype()), m, loo=loo)
        lik_mean, lik_var = means[-1], vars_[-1]                # (N, M, Q)
        mu = np.mean(lik_mean, axis=0)
        sigma2 = np.mean(np.square(lik_mean) + lik_var, axis=0) - mu**2
        return mu, sigma2
