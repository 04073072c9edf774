"""Single-GP emulator class; the counterpart of `dgp_tpu/models/gp.py`.

API mirror of reference `dgpsi/gp.py`: constructor with replicate
collapsing, train / predict / loo / metric (ALM, MICE, VIGF), the switch
to and from the Vecchia approximation, and export.  The node's compute
runs on the gp's ``device`` (default: the card).  From n >= 50000 points
the node's Vecchia neighbours come from the IVF approximate search, as in
the JAX package.  `predict` takes the test rows in chunks of
`ensemble._CHUNK`, all launched before one read back
(`kernel.gp_prediction`); ``ppredict`` and ``pmetric`` are `predict` and
`metric` with ``sharded=True``, which splits the chunks over the devices
of the gp's mesh (`parallel/mesh.py`): each share's chunks run through the
same prediction on its own device and host thread, with the same results
bit for bit.
"""
import copy

import numpy as np

from .. import config
from ..design import mice_var
from ..parallel import mesh as pmesh
from . import ensemble

#: the data size from which the gp and the dgp search neighbours with the
#: IVF approximate search (the JAX package's switch)
APPROX_NN_N = 50_000


def _collapse(X, Y):
    """(X0, Y0, indices, W_diag, sum_residual) of replicated rows, or None
    when every row of X is unique (gp.py:27-37)."""
    X0, indices = np.unique(X, return_inverse=True, axis=0)
    if len(X0) == len(X):
        return None
    indices = indices.flatten()
    N = indices.max() + 1
    counts = np.bincount(indices, minlength=N)
    sum_y = np.bincount(indices, weights=Y.flatten(), minlength=N)
    W_diag = 1.0 / counts
    Y0 = (sum_y * W_diag).reshape(-1, 1)
    residual = Y - Y0[indices, :]
    return X0, Y0, indices, W_diag, (residual.T @ residual).flatten()


class gp:
    """Gaussian-process emulation (reference gp.py:12).  ``device`` is
    where the node computes: a CUDA device by default, or 'cpu' when asked
    for."""

    def __init__(self, X, Y, kernel, check_rep=True, vecchia=False, m=25,
                 ord_fun=None, device=None):
        if Y.ndim == 1 or X.ndim == 1:
            raise Exception('The input and output data have to be numpy 2d-arrays.')
        self.device = config.resolve_device(device)
        self.check_rep = check_rep
        self._set_data(X, Y)
        self.kernel = kernel
        self.kernel.device = self.device
        self.vecch = vecchia
        self.m = min(m, self.n_data - 1)
        self.ord_fun = ord_fun
        if self.n_data >= APPROX_NN_N:
            self.kernel.nn_method = 'approx'
        self.initialize()
        if self.vecch:
            self.kernel.ord_nn()
        else:
            self.kernel.compute_stats()

    def _set_data(self, X, Y):
        dt = config.np_dtype()
        X, Y = np.asarray(X, dt), np.asarray(Y, dt)
        self.indices = None
        rep = _collapse(X, Y) if self.check_rep else None
        if rep is None:
            self.X, self.Y = X, Y
        else:
            self.X, self.Y, self.indices, self.W_diag, self.sum_residual = rep
        self.n_data = self.X.shape[0]

    def initialize(self):
        """Wire the training data into the kernel node (gp.py:80)."""
        k = self.kernel
        if k.input_dim is not None:
            k.input = self.X[:, k.input_dim]
        else:
            k.input = self.X.copy()
            k.input_dim = np.arange(self.X.shape[1])
        if self.indices is not None:
            k.rep = self.indices
            k.W_diag = self.W_diag
            k.sum_residual = self.sum_residual
        if k.connect is not None:
            if len(np.intersect1d(k.connect, k.input_dim)) != 0:
                raise Exception('The local input and global input should not overlap.')
            k.global_input = self.X[:, k.connect]
        k.output = self.Y.copy()
        k.D = k.input.shape[1]
        if k.connect is not None:
            k.D += len(k.connect)
        k.para_path = np.atleast_2d(np.concatenate((k.scale, k.length, k.nugget)))
        k.vecch = self.vecch
        k.m = self.m
        if self.ord_fun is not None:
            k.ord_fun = self.ord_fun
        if k.prior_name == 'ref':
            p = k.input.shape[1]
            if k.global_input is not None:
                p += k.global_input.shape[1]
            b = 1 / self.n_data ** (1 / p) * (k.prior_coef + p)
            k.prior_coef = np.concatenate((k.prior_coef, b))
            k.compute_cl()
        k.target = 'gp'

    def to_vecchia(self, m=25, ord_fun=None):
        if self.vecch:
            raise Exception('The GP emulator is already in Vecchia mode.')
        self.vecch = True
        self.m = min(m, self.n_data - 1)
        self.ord_fun = ord_fun
        self.kernel.vecch = True
        self.kernel.m = self.m
        self.kernel.ord_fun = ord_fun
        self.kernel.ord_nn()

    def remove_vecchia(self):
        if not self.vecch:
            raise Exception('The GP emulator is already in non-Vecchia mode.')
        self.vecch = False
        self.kernel.vecch = False
        self.kernel.compute_stats()

    def update_xy(self, X, Y, reset=False):
        """Refresh the training data, optionally resetting the
        hyper-parameters to their initial values (gp.py:144)."""
        if Y.ndim == 1 or X.ndim == 1:
            raise Exception('The input and output data have to be numpy 2d-arrays.')
        self._set_data(X, Y)
        self.m = min(self.m, self.n_data - 1)
        k = self.kernel
        if self.indices is not None:
            k.rep, k.W_diag, k.sum_residual = self.indices, self.W_diag, self.sum_residual
        else:
            k.rep = k.W_diag = k.sum_residual = None
        k.input = self.X[:, k.input_dim]
        if k.connect is not None:
            k.global_input = self.X[:, k.connect]
        k.output = self.Y.copy()
        k.m = self.m
        if reset:
            initial = k.para_path[0, :]
            k.scale, k.length, k.nugget = initial[[0]], initial[1:-1], initial[[-1]]
        if k.prior_name == 'ref':
            k.compute_cl()
        if self.vecch:
            k.ord_nn()
        else:
            k.compute_stats()

    def train(self):
        self.kernel.maximise()
        if not self.vecch:
            self.kernel.compute_stats()

    def export(self):
        """Export the trained GP for linked emulation (gp.py:218)."""
        return [copy.deepcopy(self.kernel)]

    def loo(self, method='mean_var', sample_size=50, m=30):
        """Closed-form leave-one-out (gp.py:326): dense from Rinv, Vecchia
        from the m nearest other points."""
        if self.vecch:
            from ..vecchia import api as vecchia_api
            mu, sigma2 = vecchia_api.loo_gp(self, m)
        else:
            if self.kernel.Rinv is None:
                self.kernel.compute_stats()
            Rinv, Rinv_y = self.kernel.Rinv, self.kernel.Rinv_y
            sigma2 = (1 / np.diag(Rinv)).reshape(-1, 1)
            mu = self.Y - Rinv_y[:, None] * sigma2
            sigma2 = self.kernel.scale[0] * sigma2
        if method == 'mean_var':
            if self.indices is None:
                return mu, sigma2
            return mu[self.indices, :], sigma2[self.indices, :]
        elif method == 'sampling':
            samples = np.random.normal(mu.flatten(), np.sqrt(sigma2.flatten()),
                                       size=(sample_size, len(mu))).T
            return samples if self.indices is None else samples[self.indices, :]

    def predict(self, x, method='mean_var', sample_size=50, m=50, sharded=False):
        """Predict at test inputs (gp.py:412), in chunks of
        `ensemble._CHUNK` rows.  ``sharded`` splits the chunks over the
        devices of the gp's mesh (`parallel.mesh.model_mesh`); the results
        are the same bit for bit."""
        if x.ndim == 1:
            raise Exception('The testing input has to be a numpy 2d-array')
        x = np.asarray(x, config.np_dtype())
        z_in = x[:, self.kernel.connect] if self.kernel.connect is not None else None
        self.kernel.pred_m = m
        x_in = x[:, self.kernel.input_dim]
        if not self.vecch and self.kernel.Rinv is None:
            self.kernel.compute_stats()

        def share(dev, sl):
            node = copy.copy(self.kernel)
            node.device = dev
            return node.gp_prediction(x_in[sl], None if z_in is None else z_in[sl],
                                      ensemble._CHUNK)
        if sharded:
            parts = pmesh.map_shares(pmesh.model_mesh(self.device), len(x), share,
                                     ensemble._CHUNK)
            mu, sigma2 = (np.concatenate(p) for p in zip(*parts))
        else:
            mu, sigma2 = self.kernel.gp_prediction(x_in, z_in, ensemble._CHUNK)
        if method == 'mean_var':
            return mu.reshape(-1, 1), sigma2.reshape(-1, 1)
        elif method == 'sampling':
            return np.random.normal(mu, np.sqrt(sigma2), size=(sample_size, len(x))).T

    def ppredict(self, x, method='mean_var', sample_size=50, m=50, chunk_num=None,
                 core_num=None):
        """`predict` with ``sharded=True`` (``chunk_num`` and ``core_num`` of
        the reference's process pool, gp.py:373-410, are ignored)."""
        return self.predict(x, method=method, sample_size=sample_size, m=m, sharded=True)

    def metric(self, x_cand, method='MICE', nugget_s=1., m=50, score_only=False,
               sharded=False):
        """ALM / MICE / VIGF sequential-design criteria (gp.py:271);
        ``sharded`` as in `predict`."""
        if method == 'ALM':
            _, sigma2 = self.predict(x=x_cand, m=m, sharded=sharded)
            if score_only:
                return sigma2
            idx = np.argmax(sigma2, axis=0)
            return idx, sigma2[idx, 0]
        elif method == 'MICE':
            _, sigma2 = self.predict(x=x_cand, m=m, sharded=sharded)
            sigma2_s = mice_var(x_cand, x_cand, self.kernel.input_dim, self.kernel.connect,
                                self.kernel.name, self.kernel.length, self.kernel.scale,
                                self.kernel.nugget[0], nugget_s, device=self.device)
            mice_val = sigma2 / sigma2_s
            if score_only:
                return mice_val
            idx = np.argmax(mice_val, axis=0)
            return idx, mice_val[idx, 0]
        elif method == 'VIGF':
            if self.indices is not None:
                raise Exception('VIGF is not applicable with replicated training data.')
            Dist = np.sum((x_cand[:, None, :] - self.X[None, :, :]) ** 2, axis=-1)
            index = np.argmin(Dist, axis=1)
            mu, sigma2 = self.predict(x=x_cand, m=m, sharded=sharded)
            bias = (mu - self.Y[index, :]) ** 2
            vigf = 4 * sigma2 * bias + 2 * sigma2 ** 2
            if score_only:
                return vigf
            idx = np.argmax(vigf, axis=0)
            return idx, vigf[idx, 0]
        raise ValueError(f"unknown method: {method}")

    def pmetric(self, x_cand, method='MICE', nugget_s=1., m=50, score_only=False,
                chunk_num=None, core_num=None):
        """`metric` with ``sharded=True``: its predictions split the
        candidates (``chunk_num`` and ``core_num`` are ignored)."""
        return self.metric(x_cand, method=method, nugget_s=nugget_s, m=m,
                           score_only=score_only, sharded=True)
