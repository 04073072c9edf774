"""Deep-GP model; the counterpart of `dgp_tpu/models/dgp.py`.

Ported: the constructor (data checks, replicate detection, default
structure), `initialize` for GP-only hierarchies, the Vecchia wiring of
each node, the initial imputation (10 burn-in sweeps on the model's
device), `compute_r2` and `estimate`.  Not ported yet: `train` (SEM
training; ROADMAP.md, "training"), the likelihood-specific latent
initialisers and the kernel-PCA initialiser of narrowing layers (O2).
"""
import copy

import numpy as np

from .. import config
from .node import kernel as ker
from .node import combine
from .imputation import imputer


class dgp:
    """DGP hierarchy for stochastic-imputation inference (dgp.py:26).
    ``device`` is where imputation runs ('cpu' or a CUDA device)."""

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
    def train(self, *args, **kwargs):
        raise NotImplementedError(
            "SEM training is not ported to dgp_tpu_torch yet (ROADMAP.md, "
            "'training': ops/lbfgs, models/mstep, train_chunk, kernel K1)")

    def compute_r2(self):
        for l in range(1, self.n_layer):
            for node in self.all_layer[l]:
                node.r2(overwritten=True)

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
