"""Vecchia integration with the kernel and gp classes; the counterpart of
`dgp_tpu/vecchia/api.py`.

Ordering and neighbour construction (reference kernel_class.ord_nn), and
the single-node entry points: the log-likelihood at fixed parameters (the
ESS target, through K4), the M-step objective of `kernel.maximise`
(objective and gradient through K1, one node as a group of one),
prediction, linked prediction and the gp class's LOO.  All run on the
node's device (``node.device``; default: the card).  Every neighbour
search takes the node's ``nn_method`` ('exact', or the IVF search 'approx'
that `dgp` and `gp` switch on at n >= 50000), and the ordered search keeps
the IVF centroids in ``node._ivf_cache`` to warm-start the next refresh.
A prediction's neighbour search is a ``predict.nn_search`` span
(`nn.pred_nn_t`); a prediction reads its mean and variance back once,
retrying the non-finite rows at the rungs of `core.PRED_JITTER_RUNGS` on
the host (`models.node.read_out`).
"""
from functools import partial

import numpy as np
import torch

from .. import config, gp_core, tracing
from ..models.node import read_out
from ..ops import cuda_vecchia as cv
from ..parallel import mesh as pmesh
from . import core, nn as nnmod


def ord_nn(node, ord=None, NNarray=None, pointer=False, device=None):
    """Set the Vecchia ordering and neighbour structure on a GP node; the
    search runs on ``device`` (default: the node's).  ``pointer`` also
    builds ``imp_NNarray``, the self-excluded unconstrained neighbours of
    each ordered point that the Hetero mean's exact draw conditions on
    (`core.post_het_vecch`; reference kernel_class.py:268-277)."""
    if ord is None:
        if node.ord_fun is None:
            node.ord = np.random.permutation(node.input.shape[0])
        else:
            node.ord = node.ord_fun(_scaled_input(node))
    else:
        node.ord = np.asarray(ord)
    node.rev_ord = np.argsort(node.ord)
    dev = config.resolve_device(device if device is not None else node.device)
    if NNarray is None:
        if not hasattr(node, '_ivf_cache'):
            node._ivf_cache = {}
        node.NNarray = nnmod.nn(_scaled_input(node)[node.ord], node.m,
                                method=node.nn_method, cache=node._ivf_cache,
                                device=dev)
    else:
        node.NNarray = np.asarray(NNarray)
    if pointer:
        Xo = _scaled_input(node)[node.ord]
        node.imp_NNarray = nnmod.get_pred_nn(Xo, Xo, node.m, method=node.nn_method,
                                             device=dev)[:, 1:]


def _scaled_input(node):
    return node._X() / node.length


# ----------------------------------------------------------------------
# node-level entry points
# ----------------------------------------------------------------------
def log_likelihood_func_vecch(node):
    """Vecchia log-likelihood of the node at its parameters (one K4 launch),
    with the 'ref' prior term at the characteristic length of its input."""
    ordv = node._t(node.ord, torch.int64)
    X = node._t(node._X()[node.ord])
    ll = core.vecchia_llik(X, node._t(node.output[node.ord, 0]),
                           node._t(node.NNarray, torch.int64), float(node.scale[0]),
                           node._t(node.length), float(node.nugget[0]),
                           node._nugget_diag()[ordv], node.name)
    if node.prior_name == 'ref':
        cl = gp_core.compute_cl(X, X.shape[0], node.n_length, True)
        ll = ll + gp_core.log_prior(node._t(node.length), float(node.nugget[0]),
                                    prior_name='ref', prior_coef=node._t(node.prior_coef),
                                    nugget_est=False, cl=cl)
    return float(ll)


def objective(node):
    """A Vecchia node's M-step objective for `kernel.maximise`: fg(lt (1,
    p)) -> (nll, grad, scale), each with a leading axis of one.  The blocks
    are gathered once; every evaluation is one K1 launch
    (`core.vecchia_nllik_fg`)."""
    ordv = node._t(node.ord, torch.int64)
    Xo = node._t(node._X()[node.ord])
    yo = node._t(node.output[node.ord, 0])
    NN = node._t(node.NNarray, torch.int64)
    nd = node._nugget_diag()[ordv]
    kw = node._core_kw()
    del kw['w_diag'], kw['cl']      # replicates enter through nd; cl from Xo
    kw['raw'] = cv.gather_raw_t(Xo, yo, NN, nd)

    def fg(lt):
        nll, g, scale = core.vecchia_nllik_fg(lt[0], Xo, yo, NN, nd, **kw)
        return nll[None], g[None], torch.as_tensor(scale)[None]
    return fg


def _pred_nn(node, key, query, train, rows):
    """`nn.get_pred_nn` for each slice ``rows`` of the query rows: the
    ``pred_m`` (default 50) training points ``train()`` nearest each query
    row, both length-scaled, with the node's search, as a device int
    tensor (without the first, the query itself, in the LOO state).  The
    scaled training points and the IVF index of the approximate search are
    the node's operand ``('nn', key)`` (`kernel._op`): made on every call,
    or kept from an earlier one within `kernel.prediction_operands`."""
    def make():
        xt = torch.as_tensor(train() / node.length, device=node._dev())
        return xt, (nnmod._ivf_build(xt) if nnmod.is_approx(node.nn_method, xt.shape[0])
                    else None)
    with tracing.span('predict.nn_search'):
        xt, index = node._op(('nn', key), make, 'input', 'global_input', 'length',
                             'nn_method')
        qt = torch.as_tensor(np.asarray(query / node.length), device=node._dev())
        m = int(min(node.pred_m or 50, xt.shape[0]))
        out = [nnmod.pred_nn_t(qt[c], xt, m, index) for c in rows]
        return [nn[:, 1:] for nn in out] if node.loo_state else out


def _pred_common(node):
    """The node's targets, length-scales and nugget multipliers on the
    device (`kernel._op`: kept from an earlier call within
    `kernel.prediction_operands`)."""
    return (node._op('y', lambda: node._t(node.output[:, 0]), 'output'),
            node._op('length', lambda: node._t(node.length), 'length'),
            node._op('nd', node._nugget_diag, 'output', 'W_diag'))


def gp_prediction_vecch(node, x, z, chunk=None):
    """Vecchia GP prediction at x (M, d) with global input z: the m
    nearest training points of each query (``node.pred_m``, default 50;
    one fewer, the query itself, in the LOO state); the rows in chunks of
    ``chunk`` (default: one), all launched before one read back."""
    if z is not None:
        x = np.concatenate((x, z), axis=1)
    rows = pmesh.row_chunks(len(x), chunk)
    nns = _pred_nn(node, 'X', x, node._X, rows)
    xt, w = node._t(x), node._op('X', lambda: node._t(node._X()), 'input', 'global_input')
    y, length, nd = _pred_common(node)

    def pred(extra):
        parts = [core.gp_vecch(xt[c], w, nn, y, float(node.scale[0]), length,
                               float(node.nugget[0]), nd, node.name, extra)
                 for c, nn in zip(rows, nns)]
        return tuple(torch.cat(p) for p in zip(*parts))
    return read_out(pred, core.PRED_JITTER_RUNGS)


def linkgp_prediction_vecch(node, m, v, z):
    """Vecchia linked-GP prediction under Gaussian inputs (m, v) (M, Dw)
    with the deterministic global input z (M, Dz) or None: the ``pred_m``
    (default 50) training points nearest each query's mean, with z appended
    (one fewer in the LOO state), and the I/J moments over them."""
    rows = [slice(0, len(m))]
    if z is not None or node.global_input is not None:
        NNarray, = _pred_nn(node, 'X', m if z is None else np.concatenate((m, z), axis=1),
                            node._X, rows)
    else:
        NNarray, = _pred_nn(node, 'input', m, lambda: node.input, rows)
    y, length, nd = _pred_common(node)
    return read_out(partial(
        core.link_gp_vecch, node._t(m), node._t(v), None if z is None else node._t(z),
        node._op('input', lambda: node._t(node.input), 'input'),
        None if z is None else node._op('global_input', lambda: node._t(node.global_input),
                                        'global_input'),
        NNarray, y, float(node.scale[0]), length,
        float(node.nugget[0]), nd, node.name), core.PRED_JITTER_RUNGS)


def loo_gp(gp_model, m):
    """Vecchia LOO for the gp class (reference gp.loo, Vecchia path)."""
    node = gp_model.kernel
    X = gp_model.X
    X_scale = X / node.length
    NNarray = nnmod.get_pred_nn(X_scale, X_scale, m + 1, method=node.nn_method,
                                device=node._dev())
    mean, var = read_out(partial(
        core.loo_gp_vecch, node._t(X), node._t(NNarray, torch.int64),
        node._t(node.output[:, 0]), float(node.scale[0]), node._t(node.length),
        float(node.nugget[0]), node._nugget_diag(), node.name), core.PRED_JITTER_RUNGS)
    return mean.reshape(-1, 1), var.reshape(-1, 1)
