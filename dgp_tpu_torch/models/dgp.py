"""Deep-GP model; the counterpart of `dgp_tpu/models/dgp.py`.

Ported: the constructor (data checks, replicate detection, default
structure), `initialize` for GP-only hierarchies of dense (the default) or
Vecchia nodes, with the 'ref' prior's coefficients, the Vecchia wiring of
each node, the initial imputation (10 burn-in sweeps on the model's
device), SEM training (`train`) with the NN refresh schedule of Vecchia
models and restarts, `compute_r2`, `aggregate_r2` and `estimate`.  Not
ported yet: the likelihood-specific latent initialisers and the kernel-PCA
initialiser of narrowing layers (O2), `update_xy` (O6), and multi-device
training (`ptrain`, ``sharded=True``; O7).
"""
import copy
import sys

import numpy as np
import torch

from .. import config, rng
from .node import kernel as ker
from .node import combine
from .imputation import imputer


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
        self.initialize()
        self.block = block
        self.imp = imputer(self.all_layer, self.block, self.device)
        self.imp.sample(burnin=10)
        self.compute_r2()
        self.N = 0
        self.burnin = None

    # ------------------------------------------------------------------
    # latent initialisation
    # ------------------------------------------------------------------
    def _init_layer_output(self, l, In):
        """Initial latent output of layer l: plain forwarding, or extra
        copies of random input columns when the layer widens."""
        num_kernel = len(self.all_layer[l])
        if In.shape[1] == num_kernel:
            return In.copy()
        if In.shape[1] > num_kernel:
            raise NotImplementedError(
                "the kernel-PCA initialiser of narrowing layers is not ported "
                "to dgp_tpu_torch yet (ROADMAP.md, O2)")
        extra = In[:, np.random.choice(In.shape[1], num_kernel - In.shape[1])]
        return np.concatenate((In, extra), axis=1)

    def initialize(self):
        """Wire inputs/outputs through the hierarchy (dgp.py:154)."""
        dt = config.np_dtype()
        global_in = self.X
        In = self.X
        for l in range(self.n_layer):
            layer = self.all_layer[l]
            Out = self._init_layer_output(l, In) if l != self.n_layer - 1 else None
            for k, node in enumerate(layer):
                if node.type != 'gp':
                    raise NotImplementedError(
                        "likelihood nodes are not ported to dgp_tpu_torch yet "
                        "(ROADMAP.md, O2)")
                if node.input_dim is None:
                    node.input_dim = np.arange(In.shape[1])
                node.input = In[:, node.input_dim].copy()
                if node.connect is not None:
                    if l == 0 and len(np.intersect1d(node.connect, node.input_dim)) != 0:
                        raise Exception('The local and global input should not overlap.')
                    node.global_input = global_in[:, node.connect]
                node.vecch, node.m = self.vecch, self.m
                node.device = self.device
                if self.ord_fun is not None:
                    node.ord_fun = self.ord_fun
                node.D = node.input.shape[1]
                if node.connect is not None:
                    node.D += len(node.connect)
                if l == self.n_layer - 1:
                    Ycol = np.asarray(self.Y[:, [k]], dt)
                    if self.indices is None:
                        node.output = Ycol
                    else:
                        node.rep = self.indices
                        NN = node.rep.max() + 1
                        sum_y = np.bincount(node.rep, weights=Ycol.flatten(), minlength=NN)
                        node.W_diag = 1.0 / np.bincount(node.rep, minlength=NN)
                        node.output = (sum_y * node.W_diag).reshape(-1, 1)
                        residual = Ycol - node.output[node.rep, :]
                        node.sum_residual = (residual.T @ residual).flatten()
                else:
                    node.output = np.asarray(Out[:, [k]], dt)
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
                    self._wire_vecchia_node(k, node, layer)
            if l != self.n_layer - 1:
                In = Out.copy()

    def _wire_vecchia_node(self, k, node, layer):
        """Vecchia ordering/NN for one node, reusing the ordering of an
        earlier same-wiring node (reference dgp.py:632-663)."""
        for j in range(k):
            prev = layer[j]
            same_scale = ((len(node.length) == 1 and len(prev.length) == 1)
                          or np.array_equal(node.length, prev.length))
            if (prev.vecch and same_scale
                    and np.array_equal(node.input_dim, prev.input_dim)
                    and np.array_equal(node.connect, prev.connect)):
                node.ord_nn(ord=prev.ord.copy(), NNarray=prev.NNarray.copy(),
                            device=self.device)
                return
        node.ord_nn(device=self.device)

    # ------------------------------------------------------------------
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
        ``disable`` silences the per-chunk progress line on stderr."""
        if sharded:
            raise NotImplementedError("multi-device training is not ported to "
                                      "dgp_tpu_torch yet (ROADMAP.md, O7)")
        N0 = self.N
        restarts, max_restarts = 0, 3
        while True:
            engine = self.imp._engine()
            state = engine.get_state()
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
                                                     nn_state=nn_dev)
                ok = bool(torch.stack([torch.isfinite(t).all()
                                       for grp in (para, r2, state[0])
                                       for t in grp]).all())
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

    def _append_paths(self, snapshots):
        """Append the chunks' hyper-parameter rows to each GP node's
        para_path and the R^2 rows to each globally connected node's R2."""
        para_chunks, r2_chunks = snapshots
        if para_chunks:
            merged = [np.concatenate([c[i].cpu().numpy() for c in para_chunks])
                      for i in range(len(para_chunks[0]))]
            nodes = [node for layer in self.all_layer for node in layer]
            for node, rows in zip(nodes, merged):
                node.para_path = np.vstack((node.para_path, rows))
        if r2_chunks and r2_chunks[0]:
            merged = [np.concatenate([c[i].cpu().numpy() for c in r2_chunks])
                      for i in range(len(r2_chunks[0]))]
            nodes = [node for layer in self.all_layer[1:] for node in layer
                     if node.connect is not None]
            for node, rows in zip(nodes, merged):
                node.R2 = rows if node.R2 is None else np.vstack((node.R2, rows))

    def reinit_all_layer(self, reset_lengthscale, row=0):
        """Re-initialise latents (and optionally hyper-parameters, from row
        ``row`` of each para_path) keeping the structure (dgp.py:1097)."""
        if reset_lengthscale:
            for layer in self.all_layer:
                for node in layer:
                    initial = node.para_path[row, :]
                    node.scale = np.atleast_1d(initial[0]).copy()
                    node.length = np.atleast_1d(initial[1:-1]).copy()
                    node.nugget = np.atleast_1d(initial[-1]).copy()
        self.initialize()

    def compute_r2(self):
        for l in range(1, self.n_layer):
            for node in self.all_layer[l]:
                node.r2(overwritten=True)

    def aggregate_r2(self, burnin=0.75, agg='median'):
        """Aggregated per-node R^2 diagnostics over the iterations after
        the ``burnin`` fraction (dgp.py:1481)."""
        if burnin < 0 or burnin > 1:
            raise Exception('burnin must be between 0 and 1.')
        if agg not in ('mean', 'median'):
            raise Exception("agg must be either 'median' or 'mean'.")
        fn = np.mean if agg == 'mean' else np.median
        return [[None if node.R2 is None else
                 fn(node.R2[int(len(node.R2) * burnin):, :], axis=0)
                 for node in layer] for layer in self.all_layer]

    def estimate(self, burnin=None):
        """Posterior-mean hyper-parameters -> trained structure (dgp.py:1517)."""
        self.burnin = int(self.N * (3 / 4)) if burnin is None else burnin
        final_struct = copy.deepcopy(self.all_layer)
        for layer in final_struct:
            for node in layer:
                est = np.mean(node.para_path[self.burnin:, :], axis=0)
                node.scale = np.atleast_1d(est[0])
                node.length = np.atleast_1d(est[1:-1])
                node.nugget = np.atleast_1d(est[-1])
        return final_struct
