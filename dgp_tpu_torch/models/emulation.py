"""DGP emulator: multi-imputation predictions from a trained DGP; the
counterpart of `dgp_tpu/models/emulation.py`.

The constructor draws N imputations of the latent layers (on the
emulator's device) and stores them; `predict` propagates mean and variance
layer by layer through each imputation (models/ensemble.py) and aggregates
them as a Gaussian mixture, with a final likelihood layer through the
likelihood's closed-form moments; ``method='sampling'`` draws from the
per-imputation moments with numpy's global generator, as the JAX package
does, and ``full_layer`` returns every layer.  `loo` predicts each training
point from the others (the ensemble drops each query's nearest neighbour,
itself; a dense emulator conditions on all other points), `metric` scores
candidate designs (ALM, MICE, VIGF) from the per-layer moments the ensemble
returns, and `nllik` gives the negative predicted log-likelihood.
`to_vecchia`, `remove_vecchia` and `change_vecch_state` switch the
imputations' nodes between dense and Vecchia prediction; the ensemble is
rebuilt whenever the nodes' modes differ from the ones it was built on.
`ppredict`, `ploo` and `pmetric` are `predict`, `loo` and `metric` with
``sharded=True``: the ensemble splits the query rows over the devices of
the emulator's mesh (`parallel/mesh.py`, `CompiledEnsemble.propagate`),
with the same results bit for bit; the ``chunk_num`` and ``core_num`` of
the reference's process pools are accepted and ignored.
A `predict` call is the root span ``emulator.predict`` (`tracing`).
"""
import copy
from contextlib import contextmanager

import numpy as np

from .. import config, tracing
from ..design import mice_var
from ..parallel import mesh as pmesh
from .imputation import imputer
from .ensemble import CompiledEnsemble


def _gp_nodes(all_layer):
    return [node for layer in all_layer for node in layer if node.type == 'gp']


class emulator:
    """Predictor for a trained DGP (emulation.py:14)."""

    def __init__(self, all_layer, N=10, block=True, device=None):
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        self.vecch = bool(self.all_layer[0][0].vecch)
        self.block = block
        self.device = config.resolve_device(device)
        for node in _gp_nodes(self.all_layer):
            node.device = self.device
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
        for one in self.all_layer_set:
            for node in _gp_nodes(one):
                node.device = self.device
        self._ens = None
        return self

    # ------------------------------------------------------------------
    def to_vecchia(self):
        """Predict every imputation's GP nodes under Vecchia from now on."""
        if self.vecch:
            raise Exception('The DGP emulator is already in Vecchia mode.')
        self.vecch = True
        for one in self.all_layer_set:
            for node in _gp_nodes(one):
                node.vecch = True

    def remove_vecchia(self):
        """Predict every imputation's GP nodes densely from now on."""
        if not self.vecch:
            raise Exception('The DGP emulator is already in non-Vecchia mode.')
        self.vecch = False
        for one in self.all_layer_set:
            for node in _gp_nodes(one):
                node.vecch = False
                node.compute_stats()

    @contextmanager
    def change_vecch_state(self):
        """Temporarily predict under Vecchia with each query's nearest
        neighbour (itself) left out, for LOO (emulation.py:90)."""
        nodes = [node for one in self.all_layer_set for node in _gp_nodes(one)]
        for node in nodes:
            if not self.vecch:
                node.vecch = True
            node.loo_state = True
        try:
            yield
        finally:
            for node in nodes:
                if not self.vecch:
                    node.vecch = False
                node.loo_state = False

    def loo(self, X, method=None, sample_size=50, m=30, sharded=False):
        """Leave-one-out predictions at the training inputs X, by
        self-excluding nearest-neighbour prediction (emulation.py:109): a
        Vecchia emulator conditions each point on its m nearest others, a
        dense one on all others.  Replicated rows of X are predicted once
        and the results spread back to them.  ``sharded`` as in
        `predict`."""
        if method is None:
            method = 'mean_var'
        isrep = len(X) != len(self.all_layer[0][0].input)
        if isrep:
            X, indices = np.unique(X, return_inverse=True, axis=0)
            indices = indices.flatten()
        m_pred = m + 1 if self.vecch else X.shape[0]
        with self.change_vecch_state():
            final_res = self.predict(X, method=method, sample_size=sample_size, m=m_pred,
                                     sharded=sharded)
        if isrep:
            final_res = type(final_res)(item[indices, :] for item in final_res)
        return final_res

    def ploo(self, X, method=None, sample_size=50, m=30, core_num=None):
        """`loo` with ``sharded=True`` (``core_num`` is ignored)."""
        return self.loo(X, method=method, sample_size=sample_size, m=m, sharded=True)

    # ------------------------------------------------------------------
    def _propagate(self, x, m, sharded=False):
        """Means and variances of every layer at x through the ensemble,
        rebuilt (with its replicas on other devices) when the nodes'
        dense/Vecchia modes changed since it was built (emulation.py:
        210-228); with ``sharded``, the query rows split over the
        emulator's mesh."""
        nodes = _gp_nodes(self.all_layer_set[0])
        if self._ens is None or self._ens.vecch_sig != tuple(nd.vecch for nd in nodes):
            self._ens = CompiledEnsemble(self.all_layer_set, self.device)
        loo = any(node.loo_state for node in nodes)
        mesh = pmesh.model_mesh(self.device) if sharded else None
        return self._ens.propagate(np.asarray(x, config.np_dtype()), m, loo=loo,
                                   mesh=mesh)

    def _final_moments(self, i, one_imputed, means, vars_, in_mean, in_var):
        """(mean, var) of imputation i's final layer, (M, n_out): a GP
        node's predictive moments, a likelihood node's closed-form ones on
        the last hidden layer's (a Categorical node: its latent moments)."""
        final = one_imputed[-1]
        M = in_mean.shape[0]
        if not isinstance(means[-1], dict):
            return means[-1][i], vars_[-1][i]
        if final[0].name == 'Categorical':
            idx = final[0].input_dim
            return in_mean[:, idx].copy(), in_var[:, idx].copy()
        lik_mean = np.empty((M, len(final)))
        lik_var = np.empty((M, len(final)))
        for k, node in enumerate(final):
            if node.type == 'gp':
                lik_mean[:, k], lik_var[:, k] = means[-1][k][i], vars_[-1][k][i]
            else:
                lik_mean[:, k], lik_var[:, k] = node.prediction(
                    m=in_mean[:, node.input_dim], v=in_var[:, node.input_dim])
        return lik_mean, lik_var

    def predict(self, x, method='mean_var', full_layer=False, sample_size=50, m=50,
                aggregation=True, sharded=False):
        """Predict at x (M, d) through the imputation ensemble
        (emulation.py:631).  ``method='mean_var'``: with ``aggregation``
        the N imputations combined as a Gaussian mixture, each (M, n_out)
        (a Categorical node: class probabilities from the aggregated latent
        moments), else the per-imputation lists; with ``full_layer`` a list
        over layers of the aggregated moments.  ``method='sampling'``:
        ``sample_size`` draws per imputation, a list over outputs of (M,
        N * sample_size) arrays (with ``full_layer``, a list over layers of
        such lists).  ``sharded`` splits the query rows over the devices
        of the emulator's mesh (`parallel.mesh.model_mesh`); the results
        are the same bit for bit."""
        with tracing.span('emulator.predict'):
            if x.ndim == 1:
                raise Exception('The testing input has to be a numpy 2d-array')
            x = np.asarray(x, config.np_dtype())
            final = self.all_layer[-1]
            is_cat = final[0].name == 'Categorical'
            M = len(x)
            if method == 'mean_var':
                sample_size = 1
            means, vars_ = self._propagate(x, m, sharded)
            mean_pred, variance_pred = [], []
            likelihood_mean, likelihood_variance = [], []
            for i, one_imputed in enumerate(self.all_layer_set):
                layer_means = [means[l][i] for l in range(self.n_layer - 1)]
                layer_vars = [vars_[l][i] for l in range(self.n_layer - 1)]
                lik_mean, lik_var = self._final_moments(i, one_imputed, means, vars_,
                                                        layer_means[-1], layer_vars[-1])
                for _ in range(sample_size):
                    mean_pred.append(layer_means if full_layer else layer_means[-1])
                    variance_pred.append(layer_vars if full_layer else layer_vars[-1])
                    likelihood_mean.append(lik_mean)
                    likelihood_variance.append(lik_var)
            if method == 'sampling':
                return self._sampling_output(mean_pred, variance_pred, likelihood_mean,
                                             likelihood_variance, full_layer, is_cat)
            if full_layer:
                mu_layer = [list(t) for t in zip(*mean_pred)]
                var_layer = [list(t) for t in zip(*variance_pred)]
                mu = [np.mean(ml, axis=0) for ml in mu_layer]
                mu2 = [np.mean(np.square(ml), axis=0) for ml in mu_layer]
                vm = [np.mean(vl, axis=0) for vl in var_layer]
                sigma2 = [i + j - k**2 for i, j, k in zip(mu2, vm, mu)]
                agg_mean = np.mean(likelihood_mean, axis=0)
                agg_var = (np.mean(np.square(likelihood_mean) + likelihood_variance, axis=0)
                           - agg_mean**2)
                if is_cat:
                    agg_mean, agg_var = final[0].prediction(m=agg_mean, v=agg_var)
                mu.append(agg_mean)
                sigma2.append(agg_var)
                return mu, sigma2
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

    def ppredict(self, x, method='mean_var', full_layer=False, sample_size=50, m=50,
                 chunk_num=None, core_num=None):
        """`predict` with ``sharded=True`` (``chunk_num`` and ``core_num``
        of the reference's process pool, emulation.py:578, are ignored)."""
        return self.predict(x, method=method, full_layer=full_layer,
                            sample_size=sample_size, m=m, sharded=True)

    def _sampling_output(self, mean_pred, variance_pred, likelihood_mean,
                         likelihood_variance, full_layer, is_cat):
        """Draws from the per-imputation moments in the JAX package's order
        of numpy calls (emulation.py:230-276)."""
        final = self.all_layer[-1]
        if full_layer:
            mu_layer = [list(t) for t in zip(*mean_pred)]
            var_layer = [list(t) for t in zip(*variance_pred)]
            samples = []
            samples_before_lik = None
            n_hidden = len(mu_layer)
            for l in range(n_hidden):
                layerwise = [np.random.normal(mu, np.sqrt(s2))
                             for mu, s2 in zip(mu_layer[l], var_layer[l])]
                if l == n_hidden - 1:
                    samples_before_lik = layerwise
                samples.append(list(np.asarray(layerwise).transpose(2, 1, 0)))
            lik_layer = []
            for mu_l, s2_l, dgp_sample in zip(likelihood_mean, likelihood_variance,
                                              samples_before_lik):
                realisation = np.empty_like(mu_l)
                for count, node in enumerate(final):
                    if node.type == 'gp':
                        realisation[:, count] = np.random.normal(
                            mu_l[:, count], np.sqrt(s2_l[:, count]))
                    elif is_cat:
                        realisation[:, :] = node.sampling(dgp_sample[:, node.input_dim])
                    else:
                        realisation[:, count] = node.sampling(dgp_sample[:, node.input_dim])
                lik_layer.append(realisation)
            samples.append(list(np.asarray(lik_layer).transpose(2, 1, 0)))
            return samples
        samples = []
        for mu_d, s2_d, mu_l, s2_l in zip(mean_pred, variance_pred,
                                          likelihood_mean, likelihood_variance):
            realisation = np.empty_like(mu_l)
            for count, node in enumerate(final):
                if node.type == 'gp':
                    realisation[:, count] = np.random.normal(mu_l[:, count],
                                                             np.sqrt(s2_l[:, count]))
                else:
                    dgp_sample = np.random.normal(mu_d, np.sqrt(s2_d))
                    if is_cat:
                        realisation[:, :] = node.sampling(dgp_sample[:, node.input_dim])
                    else:
                        realisation[:, count] = node.sampling(dgp_sample[:, node.input_dim])
            samples.append(realisation)
        return list(np.asarray(samples).transpose(2, 1, 0))

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def metric(self, x_cand, method='ALM', obj=None, nugget_s=1., m=50,
               score_only=False, sharded=False):
        """Sequential-design criteria over the ensemble (emulation.py:323):
        ALM (the predictive variance; of the last hidden layer under a
        likelihood), MICE (the predictive variance over the smoothed
        variance of the candidate set, averaged in log space over the
        imputations) or VIGF (the variance of the improvement for global
        fit; ``obj`` is the dgp, whose X gives each candidate's nearest
        training point).  The scores (M, D) with ``score_only``, else the
        index of the best candidate per output and its score.
        ``sharded`` as in `predict`."""
        if x_cand.ndim == 1:
            raise Exception('The candidate design set has to be a numpy 2d-array.')
        x_cand = np.asarray(x_cand, config.np_dtype())
        islik = self.all_layer[-1][0].type == 'likelihood'
        if method == 'ALM':
            if islik:
                _, sigma2 = self.predict(x=x_cand, full_layer=True, m=m, sharded=sharded)
                score = sigma2[-2]
            else:
                _, score = self.predict(x=x_cand, m=m, sharded=sharded)
        elif method == 'MICE':
            score = self._mice(x_cand, islik, nugget_s, m, sharded)
        elif method == 'VIGF':
            score = self._vigf(x_cand, islik, obj, m, sharded)
        else:
            raise ValueError(f"unknown method: {method}")
        if score_only:
            return score
        idx = np.argmax(score, axis=0)
        return idx, score[idx, np.arange(score.shape[1])]

    def pmetric(self, x_cand, method='ALM', obj=None, nugget_s=1., m=50,
                score_only=False, chunk_num=None, core_num=None):
        """`metric` with ``sharded=True`` (``chunk_num`` and ``core_num``
        are ignored)."""
        return self.metric(x_cand, method=method, obj=obj, nugget_s=nugget_s, m=m,
                           score_only=score_only, sharded=True)

    def _mice_var(self, nd, x, x_cand, nugget_s):
        return mice_var(x, x_cand, nd.input_dim, nd.connect, nd.name, nd.length,
                        nd.scale, nd.nugget[0], nugget_s, device=self.device).flatten()

    def _mice(self, x_cand, islik, nugget_s, m, sharded=False):
        """MICE scores (M, D): a 2-layer likelihood model from the first
        layer's GP prediction on ``all_layer`` (emulation.py:393), other
        models from each imputation's moments of the last GP layer and of
        its inputs."""
        if islik and self.n_layer == 2:
            layer = self.all_layer[0]
            sigma2 = np.empty((len(x_cand), len(layer)))
            for k, node in enumerate(layer):
                node.pred_m = m
                if not node.vecch:
                    node.compute_stats()
                z_in = x_cand[:, node.connect] if node.connect is not None else None
                _, sigma2[:, k] = node.gp_prediction(x=x_cand[:, node.input_dim], z=z_in)
            sigma2_s = np.column_stack([self._mice_var(nd, x_cand, x_cand, nugget_s)
                                        for nd in layer])
            return sigma2 / sigma2_s
        last = self.n_layer - 2 if islik else self.n_layer - 1
        means, vars_ = self._propagate(x_cand, m, sharded)
        mice = np.zeros((len(x_cand), len(self.all_layer[last])))
        for i, one_imputed in enumerate(self.all_layer_set):
            s_i = np.column_stack([self._mice_var(nd, means[last - 1][i], x_cand, nugget_s)
                                   for nd in one_imputed[last]])
            with np.errstate(divide='ignore'):
                mice += np.log(vars_[last][i] / s_i)
        return mice / len(self.all_layer_set)

    def _vigf(self, x_cand, islik, obj, m, sharded=False):
        """VIGF scores (M, D) from each imputation's moments of the last GP
        layer and that layer's outputs at each candidate's nearest training
        input (emulation.py:347)."""
        if obj is None:
            raise Exception('Supply the dgp object via `obj` for VIGF.')
        if not islik and obj.indices is not None:
            raise Exception('VIGF not applicable with replicates and no likelihood.')
        Dist = np.sum((x_cand[:, None, :] - obj.X[None, :, :]) ** 2, axis=-1)
        index = np.argmin(Dist, axis=1)
        last = self.n_layer - 2 if islik else self.n_layer - 1
        means, vars_ = self._propagate(x_cand, m, sharded)
        bias_set, var_set = [], []
        for i, one_imputed in enumerate(self.all_layer_set):
            out = means[last][i]
            bias = np.empty_like(out)
            for k, node in enumerate(one_imputed[last]):
                bias[:, k] = (out[:, k] - node.output[index, :].flatten()) ** 2
            bias_set.append(bias)
            var_set.append(vars_[last][i])
        bias, sigma2 = np.asarray(bias_set), np.asarray(var_set)
        E1 = np.mean(np.square(bias) + 6 * bias * sigma2 + 3 * np.square(sigma2), axis=0)
        E2 = np.mean(bias + sigma2, axis=0)
        return E1 - E2**2


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
