"""DGP emulator: multi-imputation predictions from a trained DGP; the
counterpart of `dgp_tpu/models/emulation.py`.

The constructor draws N imputations of the latent layers (on the
emulator's device) and stores them; `predict` propagates mean and variance
layer by layer through each imputation (models/ensemble.py) and aggregates
them as a Gaussian mixture, with a final likelihood layer through the
likelihood's closed-form moments.  Ported: the constructor for dense and
Vecchia structures, ``predict(method='mean_var')`` with ``aggregation`` and
`nllik`; the other methods of the JAX emulator (``method='sampling'``,
``full_layer``, LOO, design metrics) are not ported yet (O6).
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

    def _propagate(self, x, m):
        """Means and variances of every layer at x through the ensemble."""
        if self._ens is None:
            self._ens = CompiledEnsemble(self.all_layer_set, self.device)
        loo = any(node.loo_state for layer in self.all_layer_set[0] for node in layer
                  if node.type == 'gp')
        return self._ens.propagate(np.asarray(x, config.np_dtype()), m, loo=loo)

    def predict(self, x, method='mean_var', m=50, aggregation=True):
        """Mean and variance at x (M, d) through the imputation ensemble
        (emulation.py:631).  GP output nodes give their predictive moments;
        a likelihood node gives the moments of y from its closed form on the
        last hidden layer's moments (Categorical: class probabilities from
        the aggregated latent moments).  With ``aggregation`` the N
        imputations are combined as a Gaussian mixture, each (M, n_out);
        without, the per-imputation lists come back."""
        if method != 'mean_var':
            raise NotImplementedError(
                f"predict(method={method!r}) is not ported to dgp_tpu_torch yet "
                "(ROADMAP.md, O6)")
        if x.ndim == 1:
            raise Exception('The testing input has to be a numpy 2d-array')
        means, vars_ = self._propagate(x, m)
        final = self.all_layer[-1]
        is_cat = final[0].name == 'Categorical'
        M = len(x)
        likelihood_mean, likelihood_variance = [], []
        for i, one_imputed in enumerate(self.all_layer_set):
            if isinstance(means[-1], dict):
                in_mean, in_var = means[-2][i], vars_[-2][i]
                if is_cat:
                    idx = one_imputed[-1][0].input_dim
                    lik_mean, lik_var = in_mean[:, idx].copy(), in_var[:, idx].copy()
                else:
                    lik_mean = np.empty((M, len(final)))
                    lik_var = np.empty((M, len(final)))
                    # the final layer comes from THIS imputation's copy
                    for k, node in enumerate(one_imputed[-1]):
                        if node.type == 'gp':
                            lik_mean[:, k], lik_var[:, k] = means[-1][k][i], vars_[-1][k][i]
                        else:
                            lik_mean[:, k], lik_var[:, k] = node.prediction(
                                m=in_mean[:, node.input_dim], v=in_var[:, node.input_dim])
            else:
                lik_mean, lik_var = means[-1][i], vars_[-1][i]
            likelihood_mean.append(lik_mean)
            likelihood_variance.append(lik_var)
        if not aggregation:
            if is_cat:
                mu, sigma2 = [list(t) for t in zip(*(final[0].prediction(a, b)
                              for a, b in zip(likelihood_mean, likelihood_variance)))]
                return mu, sigma2
            return likelihood_mean, likelihood_variance
        mu = np.mean(likelihood_mean, axis=0)
        sigma2 = np.mean(np.square(likelihood_mean) + likelihood_variance, axis=0) - mu**2
        if is_cat:
            mu, sigma2 = final[0].prediction(mu, sigma2)
            return np.asarray(mu).reshape(M, -1), np.asarray(sigma2).reshape(M, -1)
        return mu, sigma2

    def nllik(self, x, y, m=50):
        """Negative predicted log-likelihood of y at x by Gauss-Hermite
        quadrature over the last hidden layer's predictive moments
        (emulation.py:856, functions.ghdiag): (its mean, the per-point
        values)."""
        if len(self.all_layer[-1]) != 1 or self.all_layer[-1][0].type != 'likelihood':
            raise Exception('The method needs a single likelihood node in the final layer.')
        X0, indices = np.unique(x, return_inverse=True, axis=0)
        indices = indices.flatten()
        if len(X0) != len(x):
            x = X0
        else:
            indices = np.arange(len(x))
        means, vars_ = self._propagate(x, m)
        predicted_lik = [_ghdiag(one_imputed[-1][0].pllik, means[-2][i][indices, :],
                                 vars_[-2][i][indices, :], y)
                         for i, one_imputed in enumerate(self.all_layer_set)]
        nll = -np.log(np.mean(predicted_lik, axis=0)).flatten()
        return np.mean(nll), nll


def _ghdiag(fct, mu, var, y, n_points=10):
    """Diagonal Gauss-Hermite expectation of a predicted likelihood:
    E_{f ~ N(mu, diag(var))}[ exp(pllik(y, f)) ]  (same quadrature as
    reference functions.py:233-241, re-derived).

    Substituting f_d = mu_d + sqrt(2 var_d) t_d turns each latent dimension
    into a standard Gauss-Hermite integral, so with the tensor-product rule
    E = pi^{-N/2} * sum_k (prod_d w_{k_d}) * exp(pllik(y, f_k)).  The sum is
    evaluated in log space (log-sum-exp) for stability at extreme log-liks.
    """
    from scipy.special import logsumexp

    t, w = np.polynomial.hermite.hermgauss(n_points)
    N = mu.shape[1]
    t_grid = np.meshgrid(*([t] * N), indexing='ij')
    tn = np.stack([g.ravel() for g in t_grid], axis=-1)          # (K, N)
    w_grid = np.meshgrid(*([w] * N), indexing='ij')
    log_wn = np.sum(np.log(np.stack([g.ravel() for g in w_grid], axis=-1)),
                    axis=1)                                      # (K,)
    f = mu[:, None, :] + np.sqrt(2.0 * var[:, None, :]) * tn[None]  # (M, K, N)
    ll = np.asarray(fct(y[:, None], f))
    ll = ll.reshape(ll.shape[0], ll.shape[1])
    return np.exp(logsumexp(ll + log_wn[None, :], axis=1) - 0.5 * N * np.log(np.pi))
