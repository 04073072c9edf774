"""GP node (`kernel`) class and `combine`; the counterpart of
`dgp_tpu/models/node.py`.

The node keeps the JAX package's attribute names and numpy attributes
(hyper-parameters, inputs, outputs, Vecchia ordering and neighbours), so a
structure can be carried across between the two packages
(`dgp_tpu_torch.interop`).  The compute lives in the engines
(models/compiled.py, models/ensemble.py).  Not ported yet: `maximise`, the
likelihood and prediction methods of a single node, and the dense-GP
statistics.
"""
import numpy as np

from .. import config


class kernel:
    """One GP node of a (D)GP hierarchy (reference kernel_class.kernel)."""

    def __init__(self, length, scale=1., nugget=1e-6, name='sexp',
                 prior_name='ga', prior_coef=None, bds=None, nugget_est=False,
                 scale_est=False, input_dim=None, connect=None):
        self.type = 'gp'
        dt = config.np_dtype()
        self.length = np.atleast_1d(np.asarray(length, dt))
        self.scale = np.atleast_1d(np.asarray(scale, dt))
        self.nugget = np.atleast_1d(np.asarray(nugget, dt))
        self.name = name
        self.prior_name = prior_name
        if self.prior_name == 'ga':
            self.prior_coef = (np.array([1.6, 0.3], dt) if prior_coef is None
                               else np.asarray(prior_coef, dt).copy())
            self.prior_coef[0] -= 1
        elif self.prior_name == 'inv_ga':
            self.prior_coef = (np.array([1.6, 0.3], dt) if prior_coef is None
                               else np.asarray(prior_coef, dt).copy())
            self.prior_coef[0] += 1
        elif self.prior_name == 'ref':
            self.prior_coef = (np.array([0.2], dt) if prior_coef is None
                               else np.asarray(prior_coef, dt).copy())
            self.cl = None
        elif self.prior_name is None:
            self.prior_coef = None
        else:
            raise ValueError(f"unknown prior_name: {prior_name}")
        self.nugget_est = nugget_est
        self.scale_est = scale_est
        self.input_dim = None if input_dim is None else np.asarray(input_dim)
        self.connect = None if connect is None else np.asarray(connect)
        self.para_path = None
        self.global_input = None
        self.input = None
        self.output = None
        self.rep = None
        self.vecch = False
        self.D = None
        self.ord = None
        self.rev_ord = None
        self.m = 25
        self.NNarray = None
        self.ord_fun = None
        self.bds = bds
        self.R2 = None
        self.loo_state = False
        self.sum_residual = None
        self.W_diag = None

    @property
    def n_length(self):
        return len(self.length)

    def r2(self, overwritten=False):
        """R^2 of the linear regression global_input -> input
        (kernel_class.py:227)."""
        if self.global_input is None:
            return
        X = np.concatenate((self.global_input,
                            np.ones((len(self.global_input), 1))), axis=1)
        if np.linalg.matrix_rank(self.global_input) == np.linalg.matrix_rank(X):
            X = self.global_input
        N, D = X.shape
        if N == D:
            resids = np.zeros(self.input.shape[1])
        else:
            out = np.linalg.lstsq(X, self.input, rcond=None)
            resids = out[1]
            if len(np.atleast_1d(resids)) != self.input.shape[1]:
                pred = X @ out[0]
                resids = np.sum((self.input - pred) ** 2, axis=0)
        rsq = 1 - resids / (len(self.input) * np.var(self.input, axis=0))
        if overwritten or self.R2 is None:
            self.R2 = np.atleast_2d(rsq)
        else:
            self.R2 = np.vstack((self.R2, rsq))

    def ord_nn(self, ord=None, NNarray=None, device=None):
        """Vecchia ordering and neighbours (kernel_class.py:245); the NN
        search runs on ``device``."""
        from ..vecchia import api as vecchia_api
        vecchia_api.ord_nn(self, ord=ord, NNarray=NNarray, device=device)
        # invalidates the engines' cached device copies
        self.nn_version = getattr(self, 'nn_version', 0) + 1


def combine(*layers):
    """Combine layers into one list as a DGP structure (kernel_class.py:766)."""
    return [layer for layer in layers]
