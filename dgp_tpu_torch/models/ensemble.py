"""Multi-imputation ensemble prediction; the counterpart of
`dgp_tpu/models/ensemble.py`.

The N imputations' latent layers are stacked on a leading axis and the
whole ensemble propagation -- per-layer prediction-NN search, Vecchia or
dense GP and linked-GP moments, for every imputation -- runs in plain torch
per query chunk on the engine's device.  Layer-0 inputs are shared across
imputations (the global X), so its NN search runs once per chunk, and its
dense inverse once for all chunks; deeper layers work on each imputation's
own latent inputs, and a dense node's inverses, one per imputation, are
also computed once.  A dense linked layer holds (n, n) second moments per
query; `gp_core.linkgp_predict` takes a chunk's queries in batches that fit
its memory budget.  Queries go in chunks of `_CHUNK`, or fewer where one
query's Vecchia blocks are large (a dense emulator's LOO conditions each
point on all n - 1 others): as many as keep the blocks' temporaries within
`QUERY_BUDGET` (`query_batch`); no result depends on the chunk size.
Likelihood nodes may sit in the final layer: the ensemble propagates the GP
nodes only, and the emulator applies the likelihood's closed-form moments
on the host.

A Vecchia node searches its prediction neighbours with the node path's
search (`vecchia.nn.pred_nn_t`); one whose ``nn_method`` is 'approx' (at
more than 4 * 256 training points) through an IVF index built once per
ensemble, as the JAX package's ensemble does: one index over layer 0's
shared inputs, one per imputation deeper.

The query chunks go in shares over a mesh (`parallel.mesh.Split`): one
share on the ensemble's device, or with a mesh of several devices
(`propagate(..., mesh=...)`, the emulator's p* methods) one per device.
The first share runs its chunks on the ensemble's tensors, every other on
a replica of them on its device (`_replica`, copied once per ensemble);
all chunks are launched before anything is read back, and the outputs come
to the host once.  Every query's result is its own, so any split returns
the one-device results bit for bit.

Within a chunk, a neighbour search is a ``predict.nn_search`` span, a
prediction at fixed inputs a ``predict.kriging`` span and a linked one a
``predict.linked_moments`` span (`tracing`); the one read of the outputs
of all chunks is a `tracing` read, and the jitter retry keeps each entry's
finite value, as `dgp_tpu/models/ensemble.py` does (a node's own
predictions retry by row, `models.node.read_out`).
"""
import copy

import numpy as np
import torch

from .. import config, gp_core, tracing
from ..parallel import mesh as pmesh
from ..vecchia import core as vcore
from ..vecchia import nn as vnn

_CHUNK = 2048
#: bytes of Vecchia block temporaries that one chunk of queries may hold
QUERY_BUDGET = 1 << 30


def supported(all_layer_set):
    """None if the ensemble can predict this structure, else a reason."""
    set0 = all_layer_set[0]
    for l, layer in enumerate(set0):
        for node in layer:
            if node.type == 'likelihood':
                if l != len(set0) - 1:
                    return 'likelihood node in a hidden layer'
            elif node.type != 'gp':
                return f'unknown node type {node.type}'
    return None


class CompiledEnsemble:
    """Chunked ensemble predictor for a trained DGP."""

    def __init__(self, all_layer_set, device=None):
        why = supported(all_layer_set)
        if why is not None:
            raise ValueError(why)
        self.device = config.resolve_device(device)
        self.set0 = all_layer_set[0]
        self.N = len(all_layer_set)
        self.n_layer = len(self.set0)
        self.dtype = config.default_dtype()
        dt = config.np_dtype()

        def t(a):
            return torch.tensor(np.asarray(a, dt), device=self.device)

        d_global = 0
        for layer in self.set0:
            for node in layer:
                if getattr(node, 'connect', None) is not None:
                    d_global = max(d_global, int(np.max(node.connect)) + 1)
        for node in self.set0[0]:
            d_global = max(d_global, int(np.max(node.input_dim)) + 1)
        n0 = self.set0[0][0].input.shape[0]
        Xg = np.zeros((n0, d_global), dt)
        for node in self.set0[0]:
            Xg[:, list(np.asarray(node.input_dim))] = node.input
        for layer in self.set0:
            for node in layer:
                if (getattr(node, 'connect', None) is not None
                        and node.global_input is not None):
                    Xg[:, list(np.asarray(node.connect))] = node.global_input
        self._X_global = t(Xg)
        # stacked per-imputation node outputs y_stack[l][k]: (N, n); None,
        # with no spec, for a likelihood node
        self.y_stack, self.spec = [], []
        for l in range(self.n_layer):
            lay_y, lay_spec = [], []
            for k, node in enumerate(self.set0[l]):
                if node.type != 'gp':
                    lay_y.append(None)
                    lay_spec.append(None)
                    continue
                ys = t(np.stack([s[l][k].output[:, 0] for s in all_layer_set]))
                lay_y.append(ys)
                w_diag = getattr(node, 'W_diag', None)
                lay_spec.append(dict(
                    name=node.name, vecch=bool(node.vecch), nn_method=node.nn_method,
                    input_dim=tuple(int(i) for i in node.input_dim),
                    connect=(None if node.connect is None
                             else tuple(int(i) for i in node.connect)),
                    length=t(node.length), scale=t(node.scale[0]),
                    nugget=t(node.nugget[0]),
                    nug_diag=(t(w_diag) if w_diag is not None
                              else torch.ones(ys.shape[1], dtype=self.dtype,
                                              device=self.device))))
            self.y_stack.append(lay_y)
            self.spec.append(lay_spec)
        # F[l] (N, n, width_l): column-stacked gp-node outputs of layer l
        self.F = [torch.stack(self.y_stack[l], dim=2) for l in range(self.n_layer - 1)]
        # each dense node's (Rinv, Rinv_y), once for every query chunk
        for l in range(self.n_layer):
            for k, nd in enumerate(self.spec[l]):
                if nd is not None and not nd['vecch']:
                    nd['Rinv'], nd['Rinv_y'] = self._dense_stats(l, nd, self.y_stack[l][k])
        self._build_ivf()
        #: each GP node's mode, in layer order: the emulator rebuilds the
        #: ensemble when its nodes' modes no longer match
        self.vecch_sig = tuple(nd['vecch'] for layer in self.spec for nd in layer
                               if nd is not None)
        # only Vecchia nodes take the extra diagonal of the jitter retry
        self._any_vecch = any(self.vecch_sig)
        #: copies of this ensemble for the shares after the first, by device
        self._replicas = {}

    def _replica(self, device):
        """This ensemble with copies of its tensors on ``device`` (also
        where that is its own device), made once and kept."""
        key = str(device)
        if key not in self._replicas:
            rep = copy.copy(self)
            rep.device, rep._replicas = device, {}
            for attr in ('_X_global', 'y_stack', 'spec', 'F'):
                setattr(rep, attr, _to(getattr(self, attr), device))
            self._replicas[key] = rep
        return self._replicas[key]

    def _build_ivf(self):
        """IVF indices (centroids, inverted lists) of the approximate-NN
        Vecchia nodes, on their length-scaled training inputs: layer 0's
        shared by all imputations, deeper layers' one per imputation
        (``nd['ivf']``, None for an exact node)."""
        for l in range(self.n_layer):
            for k, nd in enumerate(self.spec[l]):
                if nd is None or not nd['vecch']:
                    continue
                W, shared = self._node_train_inputs(l, nd)
                nd['ivf'] = None
                if vnn.is_approx(nd['nn_method'], W.shape[-2]):
                    full_len = torch.broadcast_to(nd['length'], (W.shape[-1],))
                    nd['ivf'] = (vnn._ivf_build(W / full_len) if shared else
                                 [vnn._ivf_build(Wi / full_len) for Wi in W])

    def _dense_stats(self, l, nd, y):
        """(Rinv, Rinv_y) of a dense node with outputs y (N, n): layer 0's
        one inverse (its inputs are global, as the JAX package uses) with
        each imputation's Rinv_y (N, n); deeper, every imputation's (N, n,
        n) and (N, n) in one batched call, with the replicate weights on
        the final layer."""
        W, _ = self._node_train_inputs(l, nd)
        if l == 0:
            Rinv, _ = gp_core.compute_stats(W, y[0], nd['length'], nd['nugget'],
                                            name=nd['name'])
            return Rinv, torch.stack([Rinv @ y[i] for i in range(self.N)])
        w_diag = nd['nug_diag'] if l == self.n_layer - 1 else None
        return gp_core.compute_stats(W, y, nd['length'], nd['nugget'], name=nd['name'],
                                     w_diag=w_diag)

    def _node_train_inputs(self, l, nd):
        """(W, shared): training inputs (n, d) shared across imputations
        for layer 0, per imputation (N, n, d) deeper."""
        if l == 0:
            Xn = self._X_global[:, list(nd['input_dim'])]
            if nd['connect'] is not None:
                Xn = torch.cat([Xn, self._X_global[:, list(nd['connect'])]], dim=1)
            return Xn, True
        W = self.F[l - 1][:, :, list(nd['input_dim'])]
        if nd['connect'] is not None:
            Z = self._X_global[:, list(nd['connect'])]
            W = torch.cat([W, torch.broadcast_to(Z[None], (self.N,) + Z.shape)], dim=2)
        return W, False

    def _chunk(self, x, m_pred, loo, extra_jit):
        """One query chunk x (Mc, d_global) -> (means, vars): per layer an
        (N, Mc, width) tensor over the layer's GP nodes (width 0 for a layer
        of likelihood nodes alone)."""
        def nn_search(q, w, m_eff, ivf):
            with tracing.span('predict.nn_search'):
                nn = vnn.pred_nn_t(q, w, m_eff, ivf)
                return nn[:, 1:] if loo else nn

        in_mean = in_var = None
        means, vars_ = [], []
        for l in range(self.n_layer):
            cols_m, cols_v = [], []
            for k, nd in enumerate(self.spec[l]):
                if nd is None:
                    continue
                y = self.y_stack[l][k]                        # (N, n)
                m_eff = min(m_pred, y.shape[1])
                W, _ = self._node_train_inputs(l, nd)
                z = x[:, list(nd['connect'])] if nd['connect'] is not None else None
                if l == 0 and not nd['vecch']:
                    xq = x[:, list(nd['input_dim'])]
                    if z is not None:
                        xq = torch.cat([xq, z], dim=1)
                    with tracing.span('predict.kriging'):
                        out = [gp_core.gp_predict(xq, W, nd['Rinv'], nd['Rinv_y'][i],
                                                  nd['scale'], nd['length'], nd['nugget'],
                                                  name=nd['name'])
                               for i in range(self.N)]
                elif not nd['vecch']:
                    dl = len(nd['input_dim'])
                    with tracing.span('predict.linked_moments', kind='dense'):
                        out = [gp_core.linkgp_predict(
                            in_mean[i][:, list(nd['input_dim'])],
                            in_var[i][:, list(nd['input_dim'])], z, W[i][:, :dl],
                            W[i][:, dl:] if z is not None else None, nd['Rinv'][i],
                            nd['Rinv_y'][i], nd['scale'], nd['length'], nd['nugget'],
                            name=nd['name'])
                            for i in range(self.N)]
                elif l == 0:
                    xq = x[:, list(nd['input_dim'])]
                    if z is not None:
                        xq = torch.cat([xq, z], dim=1)
                    NN = nn_search(xq / nd['length'], W / nd['length'], m_eff, nd['ivf'])
                    with tracing.span('predict.kriging'):
                        out = [vcore.gp_vecch(xq, W, NN, y[i], nd['scale'], nd['length'],
                                              nd['nugget'], nd['nug_diag'], nd['name'],
                                              extra_jit) for i in range(self.N)]
                else:
                    dl = len(nd['input_dim'])
                    full_len = torch.broadcast_to(nd['length'], (W.shape[2],))
                    out = []
                    for i in range(self.N):
                        mi = in_mean[i][:, list(nd['input_dim'])]
                        vi = in_var[i][:, list(nd['input_dim'])]
                        xq = mi if z is None else torch.cat([mi, z], dim=1)
                        NN = nn_search(xq / full_len, W[i] / full_len, m_eff,
                                       None if nd['ivf'] is None else nd['ivf'][i])
                        with tracing.span('predict.linked_moments', kind='vecchia'):
                            out.append(vcore.link_gp_vecch(
                                mi, vi, z, W[i][:, :dl],
                                W[i][:, dl:] if z is not None else None, NN, y[i],
                                nd['scale'], nd['length'], nd['nugget'],
                                nd['nug_diag'], nd['name'], extra_jit))
                cols_m.append(torch.stack([o[0] for o in out]))
                cols_v.append(torch.abs(torch.stack([o[1] for o in out])))
            empty = x.new_zeros((self.N, x.shape[0], 0))
            means.append(torch.stack(cols_m, dim=2) if cols_m else empty)
            vars_.append(torch.stack(cols_v, dim=2) if cols_v else empty)
            in_mean, in_var = means[l], vars_[l]
        return means, vars_

    def query_batch(self, m_pred):
        """Queries per chunk at ``m_pred`` neighbours: `_CHUNK`, or as many
        as keep one node's (m+1, m+1) blocks and their temporaries (the
        kernel's (m+1, m+1, D) differences among them; the imputations run
        one after another) within `QUERY_BUDGET`, at least one."""
        item = torch.finfo(self.dtype).bits // 8
        per_q = 1
        for l in range(self.n_layer):
            for k, nd in enumerate(self.spec[l]):
                if nd is None or not nd['vecch']:
                    continue
                m1 = min(m_pred, self.y_stack[l][k].shape[1]) + 1
                D = len(nd['input_dim']) + len(nd['connect'] or ())
                per_q = max(per_q, (8 + 4 * D) * m1 * m1 * item)
        return int(min(_CHUNK, max(1, QUERY_BUDGET // per_q)))

    def propagate(self, x, m_pred, loo=False, mesh=None):
        """Run the ensemble through all layers.  Returns (means, vars): per
        layer an (N, M, width) numpy array, or for a final layer that holds
        likelihood nodes a {node index: (N, M)} dict of its GP nodes.  The
        queries go in chunks of `query_batch`, split into shares of whole
        chunks over ``mesh`` (by default this ensemble's device alone; the
        first share is always this ensemble's):
        every share's chunks are launched on its device, the outputs joined
        on this ensemble's device and read back once.  A chunk with a
        non-finite entry is computed again at the rungs of the jitter retry,
        keeping its finite entries."""
        x = torch.as_tensor(np.asarray(x, config.np_dtype()), device=self.device)
        chunk = self.query_batch(m_pred)
        split = pmesh.Split((self.device,) + tuple(mesh or ())[1:], x.shape[0], chunk)
        bounds = [[(s, min(s + chunk, sl.stop - sl.start))
                   for s in range(0, sl.stop - sl.start, chunk)] for _, sl in split.shares]

        def run(extra, todo):
            """Chunks todo[i] of share i at the extra diagonal: a list over
            shares of lists over chunks of (means, vars) host arrays, read
            back in one transfer."""
            def share(dev, sl, i, x_i, todo_i):
                ens = self if i == 0 else self._replica(dev)
                outs = [ens._chunk(x_i[a:b], m_pred, loo, extra) for a, b in todo_i]
                return outs if i == 0 else _to(outs, self.device)
            outs = split.run(share, range(len(split)), split.cols(x, 0), todo)
            flat = [t for o in outs for mv in o for part in mv for t in part]
            if not flat:
                return outs
            host = tracing.to_host(torch.cat([t.reshape(-1) for t in flat]),
                                   'predict_out').numpy()
            arrs = iter(np.split(host, np.cumsum([t.numel() for t in flat])[:-1]))
            shapes = iter([t.shape for t in flat])
            return [[[[next(arrs).reshape(next(shapes)) for _ in part] for part in mv]
                     for mv in o] for o in outs]

        res = run(0.0, bounds)
        for extra in vcore.PRED_JITTER_RUNGS if self._any_vecch else ():
            bad = [[c for c, mv in enumerate(r)
                    if not all(np.isfinite(a).all() for part in mv for a in part)]
                   for r in res]
            if not any(bad):
                break
            again = run(extra, [[b[c] for c in cs_] for cs_, b in zip(bad, bounds)])
            for r, cs_, new in zip(res, bad, again):
                for c, mv2 in zip(cs_, new):
                    r[c] = [[np.where(np.isfinite(a), a, a2) for a, a2 in zip(p1, p2)]
                            for p1, p2 in zip(r[c], mv2)]
        chunks = [mv for r in res for mv in r]
        return tuple([self._layer_out(l, np.concatenate([mv[part][l] for mv in chunks],
                                                        axis=1))
                      for l in range(self.n_layer)] for part in range(2))

    def _layer_out(self, l, a):
        gp_cols = [k for k, nd in enumerate(self.spec[l]) if nd is not None]
        if len(gp_cols) == len(self.spec[l]):
            return a
        return {k: a[:, :, i] for i, k in enumerate(gp_cols)}


def _to(obj, device):
    """``obj`` with every tensor in it (through lists, tuples and dict
    values) copied to ``device`` (`parallel.mesh.move`)."""
    if isinstance(obj, torch.Tensor):
        return pmesh.move(obj, device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj
