"""GP node (`kernel`) class and `combine`; the counterpart of
`dgp_tpu/models/node.py`.

The node keeps the JAX package's attribute names and numpy attributes
(hyper-parameters, inputs, outputs, Vecchia ordering and neighbours), so a
structure can be carried across between the two packages
(`dgp_tpu_torch.interop`).  Its single-node methods (`maximise`, `llik`,
`log_likelihood_func`, `compute_stats`, `gp_prediction`) compute on the
node's device, ``node.device``, which the gp and dgp classes set (default:
the card); the SEM engine and the ensemble keep their own copies of the
state (models/compiled.py, models/ensemble.py).  The linked predictions
(`linkgp_prediction`, `linkgp_prediction_full`) serve `lgp`'s host loop
(models/linkgp.py).  `gp_prediction` takes its test rows in chunks of a
given size, all launched before one read back; within
`prediction_operands` the predictions reuse the training-side operands
(inputs, Rinv, the neighbour search's index) that an earlier call, of this
or an earlier block, put on the device, for as long as the node attributes
each was made from stay the same objects: `lgp.predict` calls them once
per chunk of test rows and imputation, request after request.  The kept
operands live outside the node (`_KEPT`, weak on it), so no copy or pickle
of a node carries a tensor.  Counters: ``pred_ops.made``,
``pred_ops.kept`` and ``pred_ops.upload_bytes`` (of operands made on a
CUDA device).
A prediction is a ``predict.kriging`` span, a linked one a
``predict.linked_moments`` span (`tracing`).  Every node-level prediction,
these and the Vecchia ones of `vecchia.api`, reads its mean and variance
back in one `tracing` read through `read_out`, which also makes a Vecchia
prediction's jitter retry on the host, one more read per rung used.
"""
import threading
import weakref
from contextlib import contextmanager

import numpy as np
import torch

from .. import config, gp_core, tracing
from ..ops import kernels as kops
from ..ops import lbfgs
from ..parallel import mesh as pmesh

#: node -> `_Kept`: the device operands a node's predictions made within
#: `prediction_operands`, kept between its blocks and freed with the node
_KEPT = weakref.WeakKeyDictionary()
_KEPT_LOCK = threading.Lock()


class _Kept:
    """A node's kept operands, key -> (operand, (device, dtype), the source
    attributes' objects), and its open `prediction_operands` blocks."""
    __slots__ = ('ops', 'open')

    def __init__(self):
        self.ops, self.open = {}, 0


def _nbytes(op):
    """Bytes of the tensors in an operand (a tensor, or tuples of them)."""
    if isinstance(op, torch.Tensor):
        return op.numel() * op.element_size()
    if isinstance(op, tuple):
        return sum(_nbytes(o) for o in op)
    return 0


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
        self.Rinv = None
        self.Rinv_y = None
        self.vecch = False
        self.D = None
        self.ord = None
        self.rev_ord = None
        self.m = 25
        self.pred_m = None
        self.NNarray = None
        self.imp_NNarray = None
        self.nn_method = 'exact'
        self.ord_fun = None
        self.iter_count = 0
        self.target = 'dgp'
        self.bds = bds
        self.R2 = None
        self.loo_state = False
        self.sum_residual = None
        self.W_diag = None
        #: where the single-node methods compute (None: the card)
        self.device = None

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    @property
    def n_length(self):
        return len(self.length)

    def _X(self):
        """Node input with the connected global input appended."""
        if self.global_input is not None:
            return np.concatenate((self.input, self.global_input), axis=1)
        return self.input

    def _has_rep(self):
        return self.W_diag is not None

    def _n_orig(self):
        return float(len(self.rep)) if self.rep is not None else float(len(self.output))

    def _dev(self):
        return config.resolve_device(self.device)

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or config.default_dtype(),
                               device=self._dev())

    @contextmanager
    def prediction_operands(self):
        """Within: the prediction methods reuse the device operands (`_op`)
        made in this or an earlier block while the attributes each was made
        from are the same objects, on the same device and dtype."""
        with _KEPT_LOCK:
            kept = _KEPT.get(self)
            if kept is None:
                kept = _KEPT[self] = _Kept()
            kept.open += 1
        try:
            yield self
        finally:
            with _KEPT_LOCK:
                kept.open -= 1

    def _op(self, key, make, *sources):
        """The device operand ``key``: ``make()``, which reads the node's
        attributes named ``sources``; within `prediction_operands` the one
        kept under ``key`` if those attributes are the objects it was made
        from and the device and dtype are its own."""
        kept = _KEPT.get(self)
        if kept is None or not kept.open:
            return self._made(make())
        where = (self._dev(), config.default_dtype())
        objs = tuple(getattr(self, a) for a in sources)
        old = kept.ops.get(key)
        if old is not None and old[1] == where and all(a is b for a, b in zip(old[2], objs)):
            tracing.count('pred_ops.kept')
            return old[0]
        op = self._made(make())
        kept.ops[key] = (op, where, objs)
        return op

    def _made(self, op):
        """``op``, counted as made (its bytes too, made on a card)."""
        tracing.count('pred_ops.made')
        if self._dev().type == 'cuda':
            tracing.count('pred_ops.upload_bytes', _nbytes(op))
        return op

    def _nugget_diag(self):
        """Per-point nugget multipliers: the replicate weights, or ones."""
        if self._has_rep():
            return self._t(self.W_diag)
        return torch.ones(len(self.output), dtype=config.default_dtype(),
                          device=self._dev())

    def _core_kw(self):
        """Keyword arguments of `gp_core.neg_log_lik` for this node."""
        has_rep = self._has_rep()
        return dict(name=self.name, n_length=self.n_length, scale_est=self.scale_est,
                    nugget_est=self.nugget_est, fixed_scale=float(self.scale[0]),
                    fixed_nugget=float(self.nugget[0]), prior_name=self.prior_name,
                    prior_coef=(None if self.prior_coef is None
                                else self._t(self.prior_coef)),
                    w_diag=self._t(self.W_diag) if has_rep else None,
                    sum_residual=(float(np.ravel(self.sum_residual)[0])
                                  if has_rep and self.sum_residual is not None else None),
                    n_orig=self._n_orig(),
                    cl=(self._t(self.cl) if self.prior_name == 'ref'
                        and self.cl is not None else None))

    # ------------------------------------------------------------------
    # reference-parity methods
    # ------------------------------------------------------------------
    def compute_cl(self):
        """Characteristic length for the 'ref' prior (kernel_class.py:207),
        kept as a numpy array."""
        self.cl = gp_core.compute_cl(self._t(self._X()), len(self.output), self.n_length,
                                     self.vecch).cpu().numpy()

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

    def log_t(self):
        if self.nugget_est:
            return np.log(np.concatenate((self.length, self.nugget)))
        return np.log(self.length)

    def update(self, log_theta):
        theta = np.exp(log_theta)
        if self.nugget_est:
            self.length = theta[:-1]
            self.nugget = theta[[-1]]
        else:
            self.length = theta

    def k_matrix(self):
        """Correlation matrix of the node input, as a numpy array."""
        w_diag = self._t(self.W_diag) if self._has_rep() else None
        K = kops.k_matrix(self._t(self._X()), self._t(self.length),
                          float(self.nugget[0]), self.name, w_diag)
        return K.cpu().numpy()

    def llik(self, x):
        """Negative log-likelihood and its gradient with respect to the
        log-parameters x (kernel_class.py:403); updates a profiled scale."""
        if self.prior_name == 'ref' and self.cl is None:
            self.compute_cl()
        nll, g, scale = gp_core.neg_log_lik_and_grad(
            self._t(x), self._t(self._X()), self._t(self.output[:, 0]),
            **self._core_kw())
        if self.scale_est:
            self.scale = np.atleast_1d(float(scale)).astype(config.np_dtype())
        return np.atleast_1d(float(nll)), g.cpu().numpy()

    def _bounds(self):
        """Optimisation bounds in log space (kernel_class.py:522-578)."""
        p = len(self.log_t())
        lb = np.full(p, -np.inf)
        ub = np.full(p, np.inf)
        n_len = p - 1 if self.nugget_est else p
        if self.bds is not None:
            with np.errstate(divide='ignore'):
                lb[:n_len] = np.log(self.bds[0])
                ub[:n_len] = np.log(self.bds[1])
        elif self.prior_name == 'ref':
            ub[:n_len] = 13.0
        if self.nugget_est:
            lb[-1] = np.log(1e-8)
        has_bounds = np.any(np.isfinite(lb)) or np.any(np.isfinite(ub))
        if not has_bounds:
            return None, None, False
        big = np.finfo(config.np_dtype()).max / 4
        return np.clip(lb, -big, big), np.clip(ub, -big, big), True

    def maximise(self, method='L-BFGS-B'):
        """Maximum-a-posteriori update of the hyper-parameters: bounded
        L-BFGS (maxiter 100, maxfun max(30, 20 + 5D)) on the node's device;
        a Vecchia node's objective goes through K1."""
        if self.vecch:
            from ..vecchia import api as vecchia_api
            fg = vecchia_api.objective(self)
        else:
            fg = self._dense_objective()
        lb, ub, has_bounds = self._bounds()
        maxfun = int(max(30, 20 + 5 * (self.D or self._X().shape[1])))
        lt, _, _, scale = lbfgs.minimize(
            fg, self._t(self.log_t())[None],
            self._t(lb)[None] if has_bounds else None,
            self._t(ub)[None] if has_bounds else None,
            maxiter=100, maxfun=maxfun, has_aux=True)
        lt = lt[0].cpu().numpy()
        scale = float(scale[0])
        if np.all(np.isfinite(lt)):
            self.update(lt)
            if self.scale_est and np.isfinite(scale):
                self.scale = np.atleast_1d(np.asarray(scale, config.np_dtype()))
        self.add_to_path()

    def _dense_objective(self):
        """The dense M-step objective: fg(lt (1, p)) -> (nll, grad, scale),
        each with a leading axis of one (`gp_core.neg_log_lik_and_grad`)."""
        if self.prior_name == 'ref' and self.cl is None:
            self.compute_cl()
        X, y, kw = self._t(self._X()), self._t(self.output[:, 0]), self._core_kw()

        def fg(lt):
            nll, g, scale = gp_core.neg_log_lik_and_grad(lt[0], X, y, **kw)
            return nll[None], g[None], scale[None]
        return fg

    def add_to_path(self):
        para = np.concatenate((self.scale, self.length, self.nugget))
        if self.para_path is None:
            self.para_path = np.atleast_2d(para)
        else:
            self.para_path = np.vstack((self.para_path, para))

    def log_likelihood_func(self):
        """Marginal log-likelihood at the current parameters: the ESS
        acceptance target (a Vecchia node's through K4)."""
        if self.vecch:
            from ..vecchia import api as vecchia_api
            return vecchia_api.log_likelihood_func_vecch(self)
        ref = self.prior_name == 'ref'
        return float(gp_core.log_lik_fixed(
            self._t(self._X()), self._t(self.output[:, 0]), self._t(self.length),
            float(self.scale[0]), float(self.nugget[0]), name=self.name,
            w_diag=self._t(self.W_diag) if self._has_rep() else None,
            ref_prior_coef=self._t(self.prior_coef) if ref else None,
            n_length=self.n_length, vecch=False))

    def compute_stats(self):
        """Cache Rinv and Rinv_y (numpy) for dense prediction
        (kernel_class.py:735)."""
        Rinv, Rinv_y = gp_core.compute_stats(
            self._t(self._X()), self._t(self.output[:, 0]), self._t(self.length),
            float(self.nugget[0]), name=self.name,
            w_diag=self._t(self.W_diag) if self._has_rep() else None)
        self.Rinv, self.Rinv_y = (tracing.to_host(t, 'stats').numpy() for t in (Rinv, Rinv_y))

    # ------------------------------------------------------------------
    # predictions
    # ------------------------------------------------------------------
    def gp_prediction(self, x, z, chunk=None):
        """Dense or Vecchia GP prediction at x (M, d) with global input z:
        (mean (M,), var (M,)) as numpy arrays.  The rows go in chunks of
        ``chunk`` (default: one chunk), all launched before one read back;
        no row's result depends on the other rows of its chunk, but a
        library's product may take another path at another chunk size."""
        with tracing.span('predict.kriging'):
            if self.vecch:
                from ..vecchia import api as vecchia_api
                return vecchia_api.gp_prediction_vecch(self, x, z, chunk)
            if z is not None:
                x = np.concatenate((x, z), axis=1)
            if self.Rinv is None:
                self.compute_stats()
            xt, ops = self._t(x), self._dense_ops(self._X, 'X', 'input', 'global_input')
            length = self._op('length', lambda: self._t(self.length), 'length')
            parts = [gp_core.gp_predict(xt[c], *ops, float(self.scale[0]), length,
                                        float(self.nugget[0]), name=self.name)
                     for c in pmesh.row_chunks(len(x), chunk)]
            return read_out(lambda extra: tuple(torch.cat(p) for p in zip(*parts)))

    def _dense_ops(self, train, key, *sources):
        """(training inputs ``train()``, made from the attributes
        ``sources``, Rinv, Rinv_y) on the device (`_op`; the inputs under
        ``key``)."""
        return (self._op(key, lambda: self._t(train()), *sources),
                self._op('Rinv', lambda: self._t(self.Rinv), 'Rinv'),
                self._op('Rinv_y', lambda: self._t(self.Rinv_y), 'Rinv_y'))

    def linkgp_prediction(self, m, v, z):
        """Linked-GP prediction under Gaussian inputs (mean m, variance v,
        each (M, Dw)) with the deterministic global input z (M, Dz) or None:
        (mean (M,), var (M,)) as numpy arrays; dense from Rinv, Vecchia from
        the ``pred_m`` nearest training points of each query's mean."""
        with tracing.span('predict.linked_moments', kind='vecchia' if self.vecch else 'dense'):
            if self.vecch:
                from ..vecchia import api as vecchia_api
                return vecchia_api.linkgp_prediction_vecch(self, m, v, z)
            return self._linked_dense(m, v, z, 0)

    def linkgp_prediction_full(self, m, v, m_z, v_z, z):
        """Linked prediction when the first m_z.shape[1] global dims are
        themselves Gaussian (mean m_z, variance v_z) and the rest are z or
        absent (kernel_class.py:672); dense whatever ``vecch`` says, as the
        reference computes it."""
        with tracing.span('predict.linked_moments', kind='dense'):
            return self._linked_dense(np.concatenate((m, m_z), axis=1),
                                      np.concatenate((v, v_z), axis=1), z, m_z.shape[1])

    def _linked_dense(self, m, v, z, n_mz):
        """The dense linked moments of both linked predictions: the first
        ``n_mz`` global dims are Gaussian, in (m, v) and in the training
        inputs' block; the others pair with z."""
        if self.Rinv is None:
            self.compute_stats()
        W, Rinv, Rinv_y = self._dense_ops(
            lambda: self._X()[:, :self.input.shape[1] + n_mz], ('input', n_mz),
            'input', 'global_input')
        Z = None if z is None else self._op(
            ('global_input', n_mz), lambda: self._t(self.global_input[:, n_mz:]),
            'global_input')
        length = self._op('length', lambda: self._t(self.length), 'length')
        return read_out(lambda extra: gp_core.linkgp_predict(
            self._t(m), self._t(v), None if z is None else self._t(z), W, Z, Rinv, Rinv_y,
            float(self.scale[0]), length, float(self.nugget[0]), name=self.name))

    def ord_nn(self, ord=None, NNarray=None, pointer=False, device=None):
        """Vecchia ordering and neighbours (kernel_class.py:245), with
        ``pointer`` also the neighbour sets of the Hetero exact draw; the NN
        search runs on ``device`` (default: the node's)."""
        from ..vecchia import api as vecchia_api
        vecchia_api.ord_nn(self, ord=ord, NNarray=NNarray, pointer=pointer,
                           device=device)
        # invalidates the engines' cached device copies
        self.nn_version = getattr(self, 'nn_version', 0) + 1


def read_out(pred, rungs=()):
    """(mean, var) of a node's prediction ``pred(extra)``, which returns
    both as device tensors at the extra diagonal ``extra``, as numpy
    arrays: computed at 0 and read to the host in one copy (cause
    ``predict_out``); a row whose mean or variance is not finite is taken
    again from the next rung of ``rungs`` (a Vecchia prediction's
    `vecchia.core.PRED_JITTER_RUNGS`), one read per rung used, as
    `dgp_tpu/vecchia/api.py`'s host-level retry."""
    def read(extra):
        return tracing.to_host(torch.stack(pred(extra)), 'predict_out').numpy()
    mean, var = read(0.0)
    for extra in rungs:
        bad = ~(np.isfinite(mean) & np.isfinite(var))
        if not bad.any():
            break
        m2, v2 = read(extra)
        mean, var = np.where(bad, m2, mean), np.where(bad, v2, var)
    return mean, var


def combine(*layers):
    """Combine layers into one list as a DGP structure (kernel_class.py:766)."""
    return [layer for layer in layers]
