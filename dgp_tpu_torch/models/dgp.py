"""Deep-GP model; the counterpart of `dgp_tpu/models/dgp.py`.

Ported: the constructor (data checks, replicate detection, default
structure, the Categorical likelihood's label encoding), `initialize` for
hierarchies of dense (the default) or Vecchia GP nodes with or without a
final likelihood layer (the likelihood-specific latent initialisers, the
kernel-PCA initialiser of narrowing layers, the 'ref' prior's
coefficients, the Vecchia wiring of each node with the neighbour sets of
the Hetero exact draw), the initial imputation (10 burn-in sweeps on the
model's device), SEM training (`train`) with the NN refresh schedule of
Vecchia models and restarts, `compute_r2`, `aggregate_r2`, `estimate` and
`plot`; new data (`update_xy`: the latents of points kept, conditional
means at new points, the nodes re-wired at the new n and a new imputer's
burn-in), `update_all_layer`, and the switches `to_vecchia` and
`remove_vecchia`.  From n >= 50000 points every GP node searches its
neighbours with the IVF approximate search (``nn_method = 'approx'``), as
in the JAX package.  `ptrain` is ``train(sharded=True)``: on a
one-device mesh (`parallel.mesh`) the same training; on several devices
SEM's per-point kernel calls are split over them, with the same results.
A `train` call is the root span ``sem.train`` (attr ``N``) of its spans
(`tracing`).
"""
import copy
import sys
from contextlib import contextmanager

import numpy as np
import torch

from .. import config, rng, tracing, utils
from ..parallel import mesh as pmesh
from .node import kernel as ker
from .node import combine
from .gp import gp, APPROX_NN_N
from .imputation import imputer


def _kernel_pca(In, n_components, large):
    """Latent init when a layer narrows: sigmoid-kernel PCA
    (dgp.py:565-576), the Nystrom variant for large n."""
    if large:
        return utils.NystromKPCA(n_components=n_components).fit_transform(In)
    return utils.kernel_pca(In, n_components)


class dgp:
    """DGP hierarchy for stochastic-imputation inference (dgp.py:26).
    ``device`` is where imputation and training run: a CUDA device by
    default, or 'cpu' when asked for."""

    def __init__(self, X, Y, all_layer=None, check_rep=True, block=True,
                 vecchia=False, m=25, ord_fun=None, device=None):
        dt = config.np_dtype()
        self.device = config.resolve_device(device)
        self.Y = Y
        if isinstance(self.Y, list):
            if len(self.Y) == 1:
                self.Y = self.Y[0]
            else:
                raise Exception('Y has to be a numpy 2d-array; use lgp for linked emulation.')
        if self.Y.ndim == 1 or X.ndim == 1:
            raise Exception('The input and output data have to be numpy 2d-arrays.')
        X = np.asarray(X, dt)
        if not np.issubdtype(np.asarray(self.Y).dtype, np.integer):
            self.Y = np.asarray(self.Y, dt)
        self.check_rep = check_rep
        self.indices = None
        self.counts = None
        self.X = X
        if self.check_rep:
            X0, indices, counts = np.unique(X, return_inverse=True,
                                            return_counts=True, axis=0)
            if len(X0) != len(X):
                self.X = X0
                self.indices = indices.flatten()
                self.counts = counts
        self.vecch = vecchia
        self.n_data = self.X.shape[0]
        self.nn_method = 'exact' if self.n_data < APPROX_NN_N else 'approx'
        self.m = min(m, self.n_data - 1)
        self.ord_fun = ord_fun
        if all_layer is None:
            D, Y_D = self.X.shape[1], self.Y.shape[1]
            layer1 = [ker(length=np.array([1.])) for _ in range(D)]
            layer2 = [ker(length=np.array([1.]), scale_est=True, connect=np.arange(D))
                      for _ in range(Y_D)]
            all_layer = combine(layer1, layer2)
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        final = self.all_layer[-1][0]
        if getattr(final, 'name', None) == 'Categorical':
            final.class_encoder = utils.LabelEncoder()
            self.Y = final.class_encoder.fit_transform(
                np.asarray(self.Y).flatten()).reshape(-1, 1)
            if final.num_classes is None:
                final.num_classes = len(final.class_encoder.classes_)
            if final.link is None:
                final.link = 'logit' if final.num_classes == 2 else 'softmax'
        self.initialize()
        self.block = block
        self.imp = imputer(self.all_layer, self.block, self.device)
        with self.change_init_scale():
            self.imp.sample(burnin=10)
            self.compute_r2()
        self.N = 0
        self.burnin = None

    # ------------------------------------------------------------------
    # latent initialisation
    # ------------------------------------------------------------------
    def _init_layer_output(self, l, In):
        """The initial latent output of layer l (reference dgp.initialize,
        dgp.py:154-576): the likelihood's own initialiser for the layer
        under a single likelihood node, else plain forwarding, a kernel PCA
        when the layer narrows, or extra copies of random input columns
        when it widens."""
        layer = self.all_layer[l]
        num_kernel = len(layer)
        nxt = self.all_layer[l + 1] if l < self.n_layer - 1 else None
        lik_name = getattr(nxt[0], 'name', None) if (nxt is not None and len(nxt) == 1) else None
        feeds_single_lik = (l == self.n_layer - 2 and nxt is not None and len(nxt) == 1
                            and getattr(nxt[0], 'type', '') == 'likelihood')

        if feeds_single_lik and lik_name == 'Hetero' and num_kernel == 2:
            return self._init_hetero(In, nxt[0])
        if feeds_single_lik and lik_name == 'Categorical':
            return self._init_categorical(nxt[0], num_kernel)
        if feeds_single_lik and lik_name == 'Poisson':
            return self._init_poisson()
        if feeds_single_lik and lik_name == 'ZIP':
            return self._init_zip(num_kernel)
        if feeds_single_lik and lik_name == 'ZINB':
            return self._init_zinb(num_kernel)
        if feeds_single_lik and lik_name == 'NegBin':
            return self._init_negbin(num_kernel)
        # plain forwarding / dimension adaptation
        if In.shape[1] == num_kernel:
            return In.copy()
        elif In.shape[1] > num_kernel:
            return _kernel_pca(In, num_kernel, self.vecch or self.n_data >= 500)
        extra = In[:, np.random.choice(In.shape[1], num_kernel - In.shape[1])]
        return np.concatenate((In, extra), axis=1)

    def _init_hetero(self, In, lik):
        """Pilot-GP latent init for the heteroskedastic likelihood
        (dgp.py:163-278); the pilot gps train on the model's device."""
        from scipy.special import digamma as psi
        G, D = self.X.shape
        y = np.asarray(self.Y, float).flatten()
        Out = np.empty((In.shape[0], 2))
        if self.indices is None:
            Out[:, 0] = y
            m_mu = gp(self.X, y.reshape(-1, 1),
                      ker(length=np.ones(D), name=self.all_layer[-2][0].name,
                          scale_est=True, nugget_est=True, prior_name='ref', nugget=1e-2),
                      vecchia=self.vecch, m=self.m, ord_fun=self.ord_fun,
                      device=self.device)
            m_mu.train()
            mean_mu, _ = m_mu.loo()
            resid2 = np.maximum((y - mean_mu.flatten()) ** 2, 1e-12)
            z = np.log(resid2 + 1e-12)
            m_lv = gp(self.X, z.reshape(-1, 1),
                      ker(length=np.ones(D), name=self.all_layer[-2][1].name,
                          scale_est=True, nugget_est=True, prior_name='ref', nugget=1e-2),
                      vecchia=self.vecch, m=self.m, ord_fun=self.ord_fun,
                      device=self.device)
            m_lv.train()
            mean_lv, var_lv = m_lv.loo()
            mean_lv = mean_lv.flatten()
            var_lv = np.maximum((var_lv - m_lv.kernel.nugget * m_lv.kernel.scale).flatten(), 1e-12)
            sd = np.sqrt(var_lv)
            z_init = np.clip(np.random.normal(mean_lv, sd), mean_lv - 2.576 * sd,
                             mean_lv + 2.576 * sd)
            Out[:, 1] = z_init
        else:
            counts = np.bincount(self.indices, minlength=G).astype(float)
            sumY = np.bincount(self.indices, weights=y, minlength=G)
            sumY2 = np.bincount(self.indices, weights=y * y, minlength=G)
            ybar = sumY / counts
            Out[:, 0] = ybar
            valid = counts > 1.0
            num = sumY2 - sumY**2 / np.maximum(counts, 1.0)
            s2 = np.full(G, np.nan)
            s2[valid] = np.maximum(num[valid] / (counts[valid] - 1.0), 0.0)
            v0 = np.nanmedian(s2[valid])
            s2_fill = np.where(valid, s2, v0)
            nu = (counts - 1.0) / 2.0
            bias = np.where(valid, psi(np.maximum(nu, 1e-12)) - np.log(np.maximum(nu, 1e-12)), 0.0)
            z = np.log(s2_fill + 1e-12) - bias
            m_lv = gp(self.X, z.reshape(-1, 1),
                      ker(length=np.ones(D) * 2., name=self.all_layer[-2][1].name,
                          scale_est=True, nugget_est=True, prior_name='ref', nugget=1e-1),
                      vecchia=self.vecch, m=self.m, ord_fun=self.ord_fun,
                      device=self.device)
            m_lv.train()
            mean_lv, var_lv = m_lv.loo()
            # Draw the init log-variance from the pilot GP's LOO posterior at
            # ALL sites, replicated or not.  The reference keeps the raw
            # per-site empirical log-s2 at replicated sites (dgp.py:245-268)
            # and only smooths singletons, but the empirical log-s2 has
            # trigamma((c-1)/2) ~ 2-4 nats of chi-square noise at small
            # replicate counts: the resulting white-noise init makes the
            # FIRST M-step's profile likelihood prefer the degenerate
            # flat-kernel mode (length >> input range, scale ~ 1e5 acting as
            # pure iid noise), which is self-reinforcing and freezes the
            # predictive variance dynamics.  Empirically the reference only
            # escapes this mode on its published seed (1/5 seeds tested;
            # this smoothed init lands the structured mode on 5/5) -- the
            # smoothing mirrors what the reference itself does in the
            # no-replicate branch (dgp.py:169-206).
            vls = np.maximum((var_lv - m_lv.kernel.nugget
                              * m_lv.kernel.scale).flatten(), 1e-12)
            mls = mean_lv.flatten()
            sdl = np.sqrt(vls)
            z_init = np.clip(np.random.normal(mls, sdl),
                             mls - 2 * sdl, mls + 2 * sdl)
            Out[:, 1] = z_init
        if lik.input_dim is not None:
            Out = Out[:, lik.input_dim]
        return Out

    def _init_categorical(self, lik, num_kernel):
        """Margin-style latent init for classification (dgp.py:279-326)."""
        K = lik.num_classes
        if K == 2 and num_kernel != 1:
            raise Exception('You need one GP node to feed the categorical likelihood node.')
        if K > 2 and num_kernel != K:
            raise Exception(f'You need {K} GP nodes to feed the Categorical likelihood node.')
        c = 2 * np.sqrt(40.0)
        yv = np.asarray(self.Y).ravel().astype(int)
        if self.indices is None:
            if K == 2:
                return np.where(np.asarray(self.Y) == 1, c, -c).astype(float)
            Out = -c * np.ones((self.n_data, K))
            Out[np.arange(self.n_data), yv] = c
            return Out
        m = int(self.indices.max()) + 1
        if K == 2:
            n_g = np.bincount(self.indices, minlength=m)
            k_g = np.bincount(self.indices, weights=yv.astype(float), minlength=m)
            alpha = 0.5
            p = (k_g + alpha) / (n_g + 2 * alpha)
            eps = np.finfo(float).eps
            return np.log(np.clip(p, eps, 1 - eps) / np.clip(1 - p, eps, 1)).reshape(-1, 1)
        counts = np.zeros((m, K))
        np.add.at(counts, (self.indices, yv), 1.0)
        n_g = counts.sum(axis=1, keepdims=True)
        temperature, alpha = 0.8, 0.5
        probs = (counts + alpha) / (n_g + K * alpha)
        logp = np.log(probs.clip(np.finfo(float).eps, 1.0))
        logp -= logp.mean(axis=1, keepdims=True)
        return logp / temperature

    def _init_poisson(self):
        y = np.asarray(self.Y, float)
        if self.indices is None:
            return np.log(y + .5 + 1e-12)
        G = self.X.shape[0]
        sum_y = np.bincount(self.indices, weights=y.flatten(), minlength=G)
        n_rep = np.bincount(self.indices, minlength=G)
        return np.log((sum_y + .5) / n_rep + 1e-12).reshape(-1, 1)

    def _zero_inflation_split(self, y, counts_based):
        """Moment-match (lambda, pi) for zero-inflated counts (dgp.py:337-410)."""
        lam_floor, pi_min, pi_max = 1e-6, 1e-4, 0.99
        if not counts_based:
            N = len(y)
            lam_i = np.maximum(y + 0.5, lam_floor)
            f_lambda = np.log(lam_i + 1e-12)
            n0 = (y == 0).sum()
            p0 = (n0 + 0.5) / (N + 1.0)
            mu = y.mean()
            if mu <= 0:
                pi0 = p0
            else:
                lam0 = max(mu, lam_floor)
                q0 = np.exp(-lam0)
                if q0 >= 1 - 1e-8:
                    pi0 = 0.0
                else:
                    pi0 = np.clip((p0 - q0) / (1 - q0), 0.0, pi_max)
            pi0 = np.clip(pi0, pi_min, 1 - pi_min)
            f_pi = np.full_like(f_lambda, np.log(pi0 / (1 - pi0)))
            return f_lambda, f_pi
        G = self.X.shape[0]
        idx = self.indices
        sum_y = np.bincount(idx, weights=y, minlength=G)
        n_g = np.bincount(idx, minlength=G)
        n0_g = np.bincount(idx, weights=(y == 0).astype(float), minlength=G)
        mu_g = sum_y / np.maximum(n_g, 1)
        p0_g = (n0_g + 0.1) / (n_g + 0.2)
        pos = y > 0
        global_mu_pos = y[pos].mean() if np.any(pos) else 1.0
        lam0_g = mu_g.copy()
        lam0_g[mu_g == 0.0] = global_mu_pos
        lam0_g = np.maximum(lam0_g, lam_floor)
        q_g = np.exp(-lam0_g)
        raw = (p0_g - q_g) / np.maximum(1 - q_g, 1e-8)
        raw = np.where(p0_g <= q_g, 0.0, raw)
        pi_g = np.clip(raw, 0.0, pi_max)
        lam_g = mu_g / np.maximum(1 - pi_g, 1e-3)
        lam_g = np.where(mu_g == 0.0, lam0_g, lam_g)
        lam_g = np.maximum(lam_g, lam_floor)
        pi_g = np.clip(pi_g, pi_min, 1 - pi_min)
        return np.log(lam_g + 1e-12), np.log(pi_g / (1 - pi_g))

    def _overdispersion(self, y):
        """Method-of-moments per-site overdispersion (dgp.py:526-564)."""
        eps = 1e-8
        y_mean, y_var = y.mean(), (y.var(ddof=1) if y.size > 1 else 0.0)
        sig_global = np.clip((y_var - y_mean) / (y_mean**2 + eps), 1e-3, 10.0)
        if self.indices is None:
            return None, sig_global
        G = self.X.shape[0]
        n = np.bincount(self.indices, minlength=G).astype(float)
        s1 = np.bincount(self.indices, weights=y, minlength=G)
        s2 = np.bincount(self.indices, weights=y * y, minlength=G)
        mu = (s1 + .5) / np.maximum(n, 1.0)
        var_hat = mu.copy()
        mask = n > 1
        var_hat[mask] = (s2[mask] - s1[mask]**2 / n[mask]) / (n[mask] - 1.0)
        sigma = (var_hat - mu) / (mu**2 + eps)
        bad = (~np.isfinite(sigma)) | (sigma <= 0.0)
        sigma[bad] = sig_global
        return mu, np.clip(sigma, 1e-3, 10.0)

    def _init_zip(self, num_kernel):
        y = np.asarray(self.Y, float).flatten()
        f_lam, f_pi = self._zero_inflation_split(y, self.indices is not None)
        return np.column_stack([f_lam, f_pi])

    def _init_zinb(self, num_kernel):
        y = np.asarray(self.Y, float).flatten()
        f_lam, f_pi = self._zero_inflation_split(y, self.indices is not None)
        mu_sites, sigma = self._overdispersion(y)
        if self.indices is None:
            f_sig = np.full_like(f_lam, np.log(sigma))
        else:
            f_sig = np.log(sigma)
            f_lam = np.log(np.maximum(mu_sites, 1e-6) + 1e-12)
        return np.column_stack([f_lam, f_sig, f_pi])

    def _init_negbin(self, num_kernel):
        y = np.asarray(self.Y, float).flatten()
        mu_sites, sigma = self._overdispersion(y)
        if self.indices is None:
            f_mu = np.log(y + .5 + 1e-12)
            f_sig = np.full_like(f_mu, np.log(sigma))
        else:
            f_mu = np.log(mu_sites + 1e-12)
            f_sig = np.log(sigma)
        return np.column_stack([f_mu, f_sig])

    def initialize(self):
        """Wire inputs/outputs through the hierarchy (dgp.py:154)."""
        dt = config.np_dtype()
        global_in = self.X
        In = self.X
        for l in range(self.n_layer):
            layer = self.all_layer[l]
            num_kernel = len(layer)
            Out = self._init_layer_output(l, In) if l != self.n_layer - 1 else None
            for k in range(num_kernel):
                node = layer[k]
                if l == self.n_layer - 1 and self.indices is not None:
                    node.rep = self.indices
                # inputs + wiring
                if node.input_dim is None:
                    node.input_dim = np.arange(In.shape[1])
                if l == self.n_layer - 1 and node.type == 'likelihood':
                    need = {'Poisson': 1, 'Hetero': 2, 'NegBin': 2, 'ZIP': 2, 'ZINB': 3}
                    if node.name in need and len(node.input_dim) != need[node.name]:
                        raise Exception(f'You need {need[node.name]} GP node(s) to feed '
                                        f'the {node.name} likelihood node.')
                if l == self.n_layer - 1 and node.type == 'likelihood' and node.rep is not None:
                    node.input = In[node.rep, :][:, node.input_dim]
                else:
                    node.input = In[:, node.input_dim].copy()
                if node.type == 'gp':
                    if node.connect is not None:
                        if l == 0 and len(np.intersect1d(node.connect, node.input_dim)) != 0:
                            raise Exception('The local and global input should not overlap.')
                        node.global_input = global_in[:, node.connect]
                    node.vecch, node.m, node.nn_method = self.vecch, self.m, self.nn_method
                    node.device = self.device
                    if self.ord_fun is not None:
                        node.ord_fun = self.ord_fun
                    node.D = node.input.shape[1]
                    if node.connect is not None:
                        node.D += len(node.connect)
                # outputs
                if l == self.n_layer - 1:
                    Ycol = np.asarray(self.Y[:, [k]], dt)
                    if node.type == 'likelihood':
                        node.output = np.asarray(self.Y[:, [k]])
                    elif node.rep is None:
                        node.output = Ycol
                    else:
                        NN = node.rep.max() + 1
                        sum_y = np.bincount(node.rep, weights=Ycol.flatten(), minlength=NN)
                        node.W_diag = 1.0 / np.bincount(node.rep, minlength=NN)
                        node.output = (sum_y * node.W_diag).reshape(-1, 1)
                        residual = Ycol - node.output[node.rep, :]
                        node.sum_residual = (residual.T @ residual).flatten()
                else:
                    node.output = np.asarray(Out[:, [k]], dt)
                if node.type == 'gp':
                    if node.prior_name == 'ref' and len(node.prior_coef) == 1:
                        p = node.input.shape[1]
                        if node.global_input is not None:
                            p += node.global_input.shape[1]
                        b = 1 / len(node.output) ** (1 / p) * (node.prior_coef + p)
                        node.prior_coef = np.concatenate((node.prior_coef, b))
                        node.compute_cl()
                    node.para_path = np.atleast_2d(
                        np.concatenate((node.scale, node.length, node.nugget)))
                    if node.vecch:
                        self._wire_vecchia_node(l, k, node, layer)
            if l != self.n_layer - 1:
                In = Out.copy()

    def _wire_vecchia_node(self, l, k, node, layer):
        """Vecchia ordering/NN for one node: builds the Hetero exact-posterior
        imp structure (pointer=True) when this node feeds an exact-posterior
        likelihood, and reuses the ordering of an earlier same-wiring node
        (reference dgp.py:632-663)."""
        compute_pointer = False
        if l == self.n_layer - 2:
            nxt = self.all_layer[l + 1]
            linked = [nd for nd in nxt
                      if nd.input_dim is None or k in np.atleast_1d(nd.input_dim)]
            if (len(linked) == 1 and linked[0].type == 'likelihood'
                    and linked[0].exact_post_idx is not None):
                idx = (np.where(np.atleast_1d(linked[0].input_dim) == k)[0]
                       if linked[0].input_dim is not None else np.array([k]))
                if idx.size and idx[0] in np.atleast_1d(linked[0].exact_post_idx):
                    compute_pointer = True
        for j in range(k):
            prev = layer[j]
            same_scale = ((len(node.length) == 1 and prev.type == 'gp'
                           and len(prev.length) == 1)
                          or np.array_equal(node.length, prev.length))
            if (prev.type == 'gp' and prev.vecch and same_scale
                    and np.array_equal(node.input_dim, prev.input_dim)
                    and np.array_equal(node.connect, prev.connect)):
                node.ord_nn(ord=prev.ord.copy(), NNarray=prev.NNarray.copy(),
                            pointer=compute_pointer, device=self.device)
                return
        node.ord_nn(pointer=compute_pointer, device=self.device)

    # ------------------------------------------------------------------
    @contextmanager
    def change_init_scale(self):
        """Temporarily inflate the last hidden layer's estimated scales for
        the initial imputation under a Categorical likelihood
        (dgp.py:1574)."""
        old = []
        is_cat = getattr(self.all_layer[-1][0], 'name', None) == 'Categorical'
        if is_cat:
            for node in self.all_layer[-2]:
                old.append(node.scale)
                if node.scale_est:
                    node.scale = np.array([40.0])
        yield
        if is_cat:
            for o, node in zip(old, self.all_layer[-2]):
                node.scale = o

    def _inflate_scales(self, state):
        """The state with the last hidden layer's estimated scales at 40:
        how a Categorical model enters its first SEM iteration."""
        latents, params = state
        lp = tuple(dict(p, scale=torch.full_like(p['scale'], 40.0)) if node.scale_est else p
                   for p, node in zip(params[-2], self.all_layer[-2]))
        return latents, params[:-2] + (lp,) + params[-1:]

    def train(self, N=500, ess_burn=10, disable=False, chunk_size=25,
              sharded=False):
        """SEM training: N iterations of ESS-within-Gibbs imputation
        (``ess_burn`` + 1 sweeps) and a per-node bounded L-BFGS M-step, in
        chunks of at most ``chunk_size`` iterations on the model's device.
        In a Vecchia model the orderings and neighbours are rebuilt after
        every power-of-2 global iteration g > 1 (reference dgp.py:1388),
        including at the end of a call, so that a later call continues on
        schedule.
        A non-finite hyper-parameter, R^2 or latent restarts the call from
        re-initialised latents, at most 3 times (dgp.py:1402-1412).
        ``disable`` silences the per-chunk progress line on stderr.
        ``sharded`` trains on the mesh of the model's device
        (`parallel.mesh.model_mesh`): on one device it is this training; on
        several, every per-point kernel call of SEM is split over the mesh's
        devices (`CompiledDGP.train_chunk`), with the same results bit for
        bit."""
        with tracing.span('sem.train', N=N):
            N0 = self.N
            restarts, max_restarts = 0, 3
            split = {'mesh': pmesh.model_mesh(self.device)} if sharded else {}
            while True:
                engine = self.imp._engine()
                state = engine.get_state()
                if self.N == 0 and getattr(self.all_layer[-1][0], 'name', None) == 'Categorical':
                    state = self._inflate_scales(state)
                gens = (rng.next_generator(self.device), rng.next_generator('cpu'))
                nn_dev = None  # device-refreshed NN structure, if any
                snapshots = ([], [])  # para, r2 chunks
                done = 0
                ok = True
                while done < N:
                    this = min(chunk_size, N - done)
                    if self.vecch:
                        # stop chunks at the next power-of-2 global iteration,
                        # so that the NN refresh happens on schedule
                        g = N0 + done
                        nxt = 1
                        while nxt <= g:
                            nxt *= 2
                        this = min(this, nxt - g)
                    state, para, r2 = engine.train_chunk(state, gens, this, ess_burn,
                                                         nn_state=nn_dev, **split)
                    finite = torch.stack([torch.isfinite(t).all()
                                          for grp in (para, r2, state[0]) for t in grp]).all()
                    ok = bool(tracing.to_host(finite, 'finite_check'))
                    if not ok:
                        break
                    snapshots[0].append(para)
                    snapshots[1].append(r2)
                    done += this
                    if not disable:
                        print(f"dgp.train: {done}/{N}", file=sys.stderr, flush=True)
                    g = N0 + done
                    if self.vecch and g > 1 and (g & (g - 1)) == 0:
                        if engine.supports_device_refresh():
                            nn_dev = engine.refresh_nn(state, gens[0])
                        else:
                            engine.set_state(state)
                            self.imp.update_ord_nn()
                            state = engine.get_state()
                            nn_dev = None
                if ok:
                    engine.set_state(state)
                    if nn_dev is not None:
                        engine.set_nn_state(nn_dev)
                    self._append_paths(snapshots)
                    self.N += N
                    return
                restarts += 1
                if restarts > max_restarts:
                    raise RuntimeError(f'Training failed after {max_restarts} restarts.')
                self.N = N0
                self.reinit_all_layer(reset_lengthscale=True, row=0)
                self.imp.invalidate()
                self.imp.sample(burnin=10)

    def ptrain(self, N=500, ess_burn=10, disable=False, core_num=None):
        """`train` with ``sharded=True``: SEM split over the devices of the
        model's mesh (the reference's process pool of M-step optimisations,
        dgp.py:1414, is the batched L-BFGS of every node group here;
        ``core_num`` is ignored)."""
        return self.train(N=N, ess_burn=ess_burn, disable=disable, sharded=True)

    def _append_paths(self, snapshots):
        """Append the chunks' hyper-parameter rows to each GP node's
        para_path and the R^2 rows to each globally connected node's R2."""
        para_chunks, r2_chunks = snapshots
        if para_chunks:
            merged = [np.concatenate([tracing.to_host(c[i], 'paths').numpy()
                                      for c in para_chunks])
                      for i in range(len(para_chunks[0]))]
            nodes = [node for layer in self.all_layer for node in layer
                     if node.type == 'gp']
            for node, rows in zip(nodes, merged):
                node.para_path = np.vstack((node.para_path, rows))
        if r2_chunks and r2_chunks[0]:
            merged = [np.concatenate([tracing.to_host(c[i], 'paths').numpy()
                                      for c in r2_chunks])
                      for i in range(len(r2_chunks[0]))]
            nodes = [node for layer in self.all_layer[1:] for node in layer
                     if node.type == 'gp' and node.connect is not None]
            for node, rows in zip(nodes, merged):
                node.R2 = rows if node.R2 is None else np.vstack((node.R2, rows))

    def reinit_all_layer(self, reset_lengthscale, row=0):
        """Re-initialise latents (and optionally hyper-parameters, from row
        ``row`` of each para_path) keeping the structure (dgp.py:1097)."""
        if reset_lengthscale:
            for layer in self.all_layer:
                for node in layer:
                    if node.type != 'gp':
                        continue
                    initial = node.para_path[row, :]
                    node.scale = np.atleast_1d(initial[0]).copy()
                    node.length = np.atleast_1d(initial[1:-1]).copy()
                    node.nugget = np.atleast_1d(initial[-1]).copy()
        self.initialize()

    def compute_r2(self):
        for l in range(1, self.n_layer):
            for node in self.all_layer[l]:
                if node.type == 'gp':
                    node.r2(overwritten=True)

    def aggregate_r2(self, burnin=0.75, agg='median'):
        """Aggregated per-node R^2 diagnostics over the iterations after
        the ``burnin`` fraction (dgp.py:1481)."""
        if burnin < 0 or burnin > 1:
            raise Exception('burnin must be between 0 and 1.')
        if agg not in ('mean', 'median'):
            raise Exception("agg must be either 'median' or 'mean'.")
        fn = np.mean if agg == 'mean' else np.median
        return [[None if node.type != 'gp' or node.R2 is None else
                 fn(node.R2[int(len(node.R2) * burnin):, :], axis=0)
                 for node in layer] for layer in self.all_layer]

    def estimate(self, burnin=None):
        """Posterior-mean hyper-parameters -> trained structure (dgp.py:1517)."""
        self.burnin = int(self.N * (3 / 4)) if burnin is None else burnin
        final_struct = copy.deepcopy(self.all_layer)
        for layer in final_struct:
            for node in layer:
                if node.type != 'gp':
                    continue
                est = np.mean(node.para_path[self.burnin:, :], axis=0)
                node.scale = np.atleast_1d(est[0])
                node.length = np.atleast_1d(est[1:-1])
                node.nugget = np.atleast_1d(est[-1])
        return final_struct

    def plot(self, layer_no, ker_no, width=4., height=1., ticksize=5.,
             labelsize=8., hspace=0.1):
        """Trace plots of a GP node's hyper-parameters over the SEM
        iterations (dgp.py:1543); needs matplotlib."""
        import matplotlib.pyplot as plt
        node = self.all_layer[layer_no - 1][ker_no - 1]
        if node.type != 'gp':
            print('There is nothing to plot for a likelihood node.')
            return
        n_para = node.para_path.shape[1]
        fig, axes = plt.subplots(n_para, figsize=(width, n_para * height), dpi=100,
                                 sharex=True)
        fig.tight_layout()
        fig.subplots_adjust(hspace=hspace)
        for p in range(n_para):
            axes[p].plot(node.para_path[:, p])
            axes[p].tick_params(axis='both', which='major', labelsize=ticksize)
            if p == 0:
                axes[p].set_ylabel(r'$\sigma^2$', fontsize=labelsize)
            elif p == n_para - 1:
                axes[p].set_ylabel(r'$\eta$', fontsize=labelsize)
            else:
                axes[p].set_ylabel(r'$\gamma_{%i}$' % p, fontsize=labelsize)
        plt.show()

    # ------------------------------------------------------------------
    # new data and structures
    # ------------------------------------------------------------------
    def update_all_layer(self, all_layer):
        """Swap in an externally supplied structure (for example one trained
        separately) with its hyper-parameters and latents, and reset the
        training state (dgp.py:760-823): the Vecchia nodes re-wired, a new
        imputer on the model's device and 10 burn-in sweeps."""
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        for l, layer in enumerate(self.all_layer):
            for k, node in enumerate(layer):
                if l == self.n_layer - 1 and getattr(node, 'rep', None) is not None:
                    self.indices = node.rep
                if node.type != 'gp':
                    continue
                node.device = self.device
                node.para_path = np.atleast_2d(
                    np.concatenate((node.scale, node.length, node.nugget)))
                node.D = node.input.shape[1]
                if node.connect is not None:
                    node.D += len(node.connect)
                if node.vecch:
                    self._wire_vecchia_node(l, k, node, layer)
                if node.prior_name == 'ref':
                    p = node.input.shape[1]
                    if node.global_input is not None:
                        p += node.global_input.shape[1]
                    node.prior_coef[1] = (1 / len(node.output) ** (1 / p)
                                          * (node.prior_coef[0] + p))
                    node.compute_cl()
        self.vecch = any(node.vecch for node in self._gp_nodes())
        self.imp = imputer(self.all_layer, self.block, self.device)
        self.imp.sample(burnin=10)
        self.compute_r2()
        self.N = 0
        self.burnin = None

    def _gp_nodes(self):
        return [node for layer in self.all_layer for node in layer if node.type == 'gp']

    def update_xy(self, X, Y, reset=False):
        """Train on new data X, Y from the current state (dgp.py:824): with
        ``reset`` from re-initialised latents and the first hyper-parameters
        (10 burn-in sweeps); when the new inputs are a subset or a superset
        of the old, the latents of the points kept stay and new points get
        each node's conditional mean (50 sweeps); otherwise re-initialised
        latents at the current hyper-parameters (200 sweeps).  A new imputer
        on the model's device draws the burn-in."""
        dt = config.np_dtype()
        if isinstance(Y, list):
            Y = Y[0]
        if Y.ndim == 1 or X.ndim == 1:
            raise Exception('The input and output data have to be numpy 2d-arrays.')
        final = self.all_layer[-1][0]
        if getattr(final, 'name', None) == 'Categorical':
            Y = final.class_encoder.transform(np.asarray(Y).flatten()).reshape(-1, 1)
        self.Y = Y if np.issubdtype(np.asarray(Y).dtype, np.integer) else np.asarray(Y, dt)
        origin_X = self.X.copy()
        self.indices = None
        X = np.asarray(X, dt)
        self.X = X
        if self.check_rep:
            X0, indices, counts = np.unique(X, return_inverse=True, return_counts=True,
                                            axis=0)
            if len(X0) != len(X):
                self.X = X0
                self.indices = indices.flatten()
                self.counts = counts
        self.n_data = self.X.shape[0]
        self.m = min(self.m, self.n_data - 1)
        if reset:
            self.reinit_all_layer(reset_lengthscale=True)
            burnin = 10
        elif (self.X[:, None] == origin_X).all(-1).any(-1).all():
            self._subset_latents(np.where((origin_X == self.X[:, None]).all(-1))[1])
            burnin = 50
        elif (origin_X[:, None] == self.X).all(-1).any(-1).all():
            self._extend_latents(np.where((self.X == origin_X[:, None]).all(-1))[1])
            burnin = 50
        else:
            self.reinit_all_layer(reset_lengthscale=False)
            burnin = 200
        self.imp = imputer(self.all_layer, self.block, self.device)
        self.imp.sample(burnin=burnin)
        self.compute_r2()

    def _subset_latents(self, sub_idx):
        """The new X is a subset of the old: keep the latents of its points
        (dgp.py:1014) and re-wire the Vecchia nodes at the new n."""
        for l in range(self.n_layer):
            for k, node in enumerate(self.all_layer[l]):
                if l == self.n_layer - 1:
                    if node.type == 'gp' or node.rep is None:
                        node.input = node.input[sub_idx, :]
                    else:
                        uniq = np.concatenate(
                            [np.unique(node.input[node.rep == i, :], axis=0)
                             for i in range(np.max(node.rep) + 1)], axis=0)
                        node.input = uniq[sub_idx, :]
                    if node.type != 'gp' and self.indices is not None:
                        node.input = node.input[self.indices, :]
                    node.rep = self.indices
                else:
                    node.input = node.input[sub_idx, :]
                if node.type == 'gp' and node.connect is not None:
                    node.global_input = self.X[:, node.connect].copy()
                self._refresh_node_output(l, k, node, sub_idx=sub_idx)
                if node.type == 'gp':
                    node.m = self.m
                    if node.vecch:
                        self._wire_vecchia_node(l, k, node, self.all_layer[l])

    def _extend_latents(self, sub_idx):
        """The old X is a subset of the new: keep the latents of the old
        points and give each hidden node's new points its conditional mean
        (dgp.py:890) -- by its Vecchia prediction, or densely after
        `compute_stats` -- then re-wire the Vecchia nodes at the new n."""
        global_in = self.X.copy()
        In = self.X.copy()
        mask = np.zeros(len(self.X), bool)
        mask[sub_idx] = True
        for l in range(self.n_layer):
            layer = self.all_layer[l]
            hidden = l != self.n_layer - 1
            if hidden:
                Out = np.empty((len(In), len(layer)))
            for k, node in enumerate(layer):
                if hidden:
                    node.m = self.m
                    x_new = In[~mask, :][:, node.input_dim]
                    z_new = (global_in[~mask, :][:, node.connect]
                             if node.connect is not None else None)
                    if not node.vecch:
                        node.compute_stats()
                    mu, _ = node.gp_prediction(x_new, z_new)
                    node.input = In[:, node.input_dim].copy()
                    Out[sub_idx, k] = node.output.flatten()
                    Out[~mask, k] = mu
                    node.output = Out[:, [k]].copy()
                    if node.connect is not None:
                        node.global_input = global_in[:, node.connect].copy()
                    if node.vecch:
                        self._wire_vecchia_node(l, k, node, layer)
                    continue
                node.rep = self.indices
                if node.rep is None or node.type == 'gp':
                    node.input = In[:, node.input_dim].copy()
                else:
                    node.input = In[node.rep, :][:, node.input_dim].copy()
                if node.type == 'gp' and node.connect is not None:
                    node.global_input = global_in[:, node.connect].copy()
                self._refresh_node_output(l, k, node)
                if node.type == 'gp':
                    node.m = self.m
                    if node.vecch:
                        self._wire_vecchia_node(l, k, node, layer)
            if hidden:
                In = Out.copy()

    def _refresh_node_output(self, l, k, node, sub_idx=None):
        """A node's output after new data: the final layer's from Y (means
        over replicates, with their weights and residual sum), a hidden
        node's latents at ``sub_idx``."""
        dt = config.np_dtype()
        if l == self.n_layer - 1:
            Ycol = self.Y[:, [k]]
            if node.type == 'likelihood':
                node.output = np.asarray(Ycol).copy()
            elif node.rep is None:
                node.output = np.asarray(Ycol, dt).copy()
                node.W_diag = None
                node.sum_residual = None
            else:
                NN = node.rep.max() + 1
                sum_y = np.bincount(node.rep, weights=np.asarray(Ycol, dt).flatten(),
                                    minlength=NN)
                node.W_diag = 1.0 / np.bincount(node.rep, minlength=NN)
                node.output = (sum_y * node.W_diag).reshape(-1, 1)
                residual = np.asarray(Ycol, dt) - node.output[node.rep, :]
                node.sum_residual = (residual.T @ residual).flatten()
        elif sub_idx is not None:
            node.output = node.output[sub_idx, :].copy()
        if node.type == 'gp' and node.prior_name == 'ref':
            node.compute_cl()

    def to_vecchia(self, m=25, ord_fun=None):
        """Switch every GP node to the Vecchia approximation with m
        neighbours (dgp.py:950): orderings and neighbours built, a new
        imputer."""
        if self.vecch:
            raise Exception('The DGP structure is already in Vecchia mode.')
        self.vecch = True
        self.m = min(m, self.n_data - 1)
        self.ord_fun = ord_fun
        for node in self._gp_nodes():
            node.vecch, node.m, node.ord_fun = True, self.m, ord_fun
        self.imp = imputer(self.all_layer, self.block, self.device)
        self.imp.update_ord_nn()

    def remove_vecchia(self):
        """Switch every GP node back to dense computation (dgp.py:963), with
        a new imputer."""
        if not self.vecch:
            raise Exception('The DGP structure is already in non-Vecchia mode.')
        self.vecch = False
        for node in self._gp_nodes():
            node.vecch = False
        self.imp = imputer(self.all_layer, self.block, self.device)
