"""DGP engine: the SEM iteration (ESS-within-Gibbs I-step and batched
L-BFGS M-step) on tensors; the counterpart of `dgp_tpu/models/compiled.py`.

The DGP's dynamic state is

    state = (latents, params)
      latents : tuple over hidden layers of (n, M_l) tensors
      params  : tuple over layers of tuples of per-GP-node
                {'length': (p,), 'nugget': (), 'scale': ()} tensors

plus, under the Vecchia approximation, a per-node neighbour structure

    nn_state : tuple over layers of tuples of {'ord', 'rev', 'NN'}

all on the engine's device.  The JAX package traces a chunk of SEM
iterations into one program; here `train_chunk` is a plain loop that runs
eagerly, with the ESS rounds' host checks as its only synchronisations.

The kernels carry the Vecchia hot paths (on the CPU their wrappers run
the plain versions; blocks outside the kernels' bounds --
`ops.cuda_vecchia.use_kernel` -- go, on every device, the large-block
route of `vecchia.core`, and the angle views step aside): K2 evaluates the ESS
candidates of a layer through maintained angle views
(`_build_angle_plan` / `_plan_ll`), K3
gives the prior draws' conditional weights (`vecchia.core.cond_weights`),
K4 the per-node log-likelihood (`_gp_loglik`) of node-wise ESS and of the
block ESS of layers the angle views do not cover (upper nodes with the
'ref' prior or dense), and K1 every objective and gradient of a Vecchia
M-step group (`models/mstep.py`).  Dense GP nodes factor their (n, n)
matrices with torch.linalg (prior draws, log-likelihoods, the batched dense
M-step), as the JAX package does with XLA.

A final layer may hold likelihood nodes (`likelihoods.py`): their
log-likelihood of the last hidden layer is a term of that layer's ESS
target (evaluated on all candidates of a round in one call), they have no
hyper-parameters, and the mean of a Hetero node is drawn exactly
(`_post_het`, or `vecchia.core.post_het_vecch` for a Vecchia node), which
makes its layer node-wise.

A Vecchia model's NN refresh (`refresh_nn`) rebuilds every node's ordering
and neighbours on the device, with the exact search or, for a node whose
``nn_method`` is 'approx' (`dgp` sets it at n >= 50000), the IVF search of
`vecchia.nn`, at any n in one path.

Every per-point kernel call of SEM -- K1, K2, K3, K4 and the large-block
route -- runs over the shares of the Vecchia ordering (`_Shares`,
`parallel.mesh.Split`): one share on the engine's device, or with a mesh
of several devices (`train_chunk(mesh=...)`, `dgp.train(sharded=True)`)
one per device.  Each share's chunk statics, angle views and M-step blocks
are built on its device from its rows of the neighbour sets and its copy
of the state (`parallel.mesh.shard_latent_state`, refreshed after every
change of the latents); the per-point outputs come back to the engine's
device, joined in share order, and are reduced there.  Random draws, the
ancestral pass, ESS decisions, the L-BFGS state, likelihood nodes, dense
nodes, R^2 and the NN refresh stay on the engine's device.

Spans (`tracing`): ``sem.chunk`` (`train_chunk`), ``sem.istep``,
``sem.prior_draw``, ``sem.ess`` (one transition of a layer, attr ``route``
'block', or of a node of a node-wise layer, ``route`` 'nodewise'),
``sem.exact_draw`` (the exact draw of a Hetero mean; attrs ``layer`` and
``kind``, 'vecchia' or 'dense'), ``sem.lik`` (one evaluation of a
likelihood node's log-likelihood, `_lik_loglik`; attrs ``name``, the
node's, and ``candidates``, the states it evaluated), ``sem.mstep`` and
``nn.refresh``; a block ``sem.ess`` span also carries ``cols``, the
latent columns the transition moves.  The state's reads back to the node
objects are `tracing.to_host` reads.
Counters: ``exact_draws.vecchia`` and ``exact_draws.dense`` (the engine's
`exact_draws` reads them), ``lik.evals`` (calls of a likelihood node's
log-likelihood) and ``lik.candidates`` (the states those calls evaluated);
``prior.passes`` (the ancestral passes of the Vecchia prior draws, one a
draw of one node, batched over sweeps or not) and ``prior.columns`` (the
node columns the prior draws gave, dense or Vecchia: S for a batch of S
sweeps' draws).
"""
import numpy as np
import torch

from .. import config, gp_core, likelihoods, tracing
from ..ess import ess_update
from ..ops import cuda_vecchia as cv
from ..ops import kernels as kops
from ..ops import linalg
from ..parallel import mesh as pmesh
from ..vecchia import core as vcore
from ..vecchia import nn as vnn
from . import mstep


class NodeSpec:
    """Static description of one node (GP or likelihood)."""

    def __init__(self, obj, layer, n_layer):
        self.kind = obj.type  # 'gp' | 'likelihood'
        self.name = obj.name
        self.input_dim = tuple(int(i) for i in obj.input_dim)
        self.connect = None if getattr(obj, 'connect', None) is None else \
            tuple(int(i) for i in obj.connect)
        self.is_final = layer == n_layer - 1
        if self.kind != 'gp':
            self.link = getattr(obj, 'link', None)
            self.num_classes = getattr(obj, 'num_classes', None)
            self.robustmax_eps = getattr(obj, 'robustmax_eps', 1e-3)
            self.exact_post_idx = getattr(obj, 'exact_post_idx', None)
            self.has_rep = obj.rep is not None
            self.vecch = False
            return
        self.n_length = len(obj.length)
        self.scale_est = bool(obj.scale_est)
        self.nugget_est = bool(obj.nugget_est)
        self.prior_name = obj.prior_name
        self.prior_coef = None if obj.prior_coef is None else \
            tuple(float(c) for c in obj.prior_coef)
        self.bds = None if obj.bds is None else tuple(float(b) for b in obj.bds)
        self.has_rep = obj.W_diag is not None
        # the node's input width (node.D of the object graph)
        self.D = len(self.input_dim) + (len(self.connect) if self.connect else 0)
        self.vecch = bool(getattr(obj, 'vecch', False))


class _Share:
    """One share of the Vecchia ordering: its range ``sl`` of the points,
    the engine's static tensors (the first share's are the engine's own,
    every other share's copies on its device), every Vecchia node's whole
    ordering and the share's rows of its neighbour sets (``nn``), and its
    chunk statics (``cs``)."""

    def __init__(self, engine, device, sl, nn_state, first):
        def put(t):
            return t if first or t is None else pmesh.move(t, device)
        self.sl = sl
        self.X = put(engine.X)
        self.y_final = [put(y) for y in engine.y_final]
        self.w_diag = [put(w) for w in engine.w_diag]
        self.nn = tuple(tuple(None if d is None else
                              {'ord': put(d['ord']), 'NN': put(d['NN'][sl])}
                              for d in layer) for layer in nn_state or ())
        self.cs = engine._chunk_static(self)


class _Shares:
    """The shares of the Vecchia ordering over ``mesh`` (by default the
    engine's device alone: one share, on the engine's own tensors; the
    first share is always the engine's), and the state on each share's
    device (`sync`)."""

    def __init__(self, engine, nn_state, mesh=None):
        self.split = pmesh.Split((engine.device,) + tuple(mesh or ())[1:], engine.n)
        self.items = [_Share(engine, dev, sl, nn_state, i == 0)
                      for i, (dev, sl) in enumerate(self.split.shares)]
        self.states = None

    def sync(self, latents, params):
        """The state on every share's device: itself on the first, a copy
        on each other (n x width values per latent layer)."""
        st = pmesh.shard_latent_state((latents, params), self.split.devices)
        self.states = [st] if len(self.split) == 1 else list(st)


class CompiledDGP:
    """SEM training and ESS-within-Gibbs imputation for one DGP structure on
    one device (default: the card)."""

    def __init__(self, all_layer, block=True, device=None):
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        self.block = block
        self.device = config.resolve_device(device)
        self.spec = [[NodeSpec(node, l, self.n_layer) for node in layer]
                     for l, layer in enumerate(all_layer)]
        self.dtype = config.default_dtype()
        self._draws0 = tracing.totals('exact_draws.')
        self._extract_data()

    @property
    def exact_draws(self):
        """The exact Hetero-mean draws made since the engine was built, by
        path: a view of the counters ``exact_draws.<path>``."""
        t = tracing.totals('exact_draws.')
        return {k: t.get('exact_draws.' + k, 0) - self._draws0.get('exact_draws.' + k, 0)
                for k in ('dense', 'vecchia')}

    def _t(self, a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype or self.dtype,
                            device=self.device)

    # ------------------------------------------------------------------
    # data/state movement between the object graph and tensors
    # ------------------------------------------------------------------
    def _extract_data(self):
        first = self.all_layer[0][0]
        n = first.input.shape[0]
        d_global = 0
        for specs in self.spec:
            for sp in specs:
                if sp.connect is not None:
                    d_global = max(d_global, max(sp.connect) + 1)
        for sp in self.spec[0]:
            d_global = max(d_global, max(sp.input_dim) + 1)
        X = np.zeros((n, d_global), config.np_dtype())
        for node, sp in zip(self.all_layer[0], self.spec[0]):
            X[:, list(sp.input_dim)] = node.input
        for layer, specs in zip(self.all_layer, self.spec):
            for node, sp in zip(layer, specs):
                if sp.connect is not None and node.global_input is not None:
                    X[:, list(sp.connect)] = node.global_input
        self.X = self._t(X)
        self.n = n
        self.y_final, self.w_diag, self.sum_res, self.y_lik = [], [], [], []
        rep = None
        for node, sp in zip(self.all_layer[-1], self.spec[-1]):
            is_gp = sp.kind == 'gp'
            self.y_final.append(self._t(node.output[:, 0]) if is_gp else None)
            self.y_lik.append(None if is_gp else self._t(node.output))
            self.w_diag.append(self._t(node.W_diag) if is_gp and sp.has_rep else None)
            self.sum_res.append(float(np.ravel(node.sum_residual)[0])
                                if is_gp and sp.has_rep else None)
            if sp.has_rep:
                rep = np.asarray(node.rep)
        self.n_orig = float(n) if rep is None else float(len(rep))
        self.rep = None if rep is None else self._t(rep, torch.int64)
        if rep is not None:
            # (n, most replicates) observation indices of each site, padded:
            # sums over a site's replicates as a gather and a row sum, which
            # add in the same order on every run (an index_add_ on the card
            # adds atomically, in no fixed order)
            order = np.argsort(rep, kind='stable')
            counts = np.bincount(rep, minlength=n)
            col = np.arange(len(rep)) - np.repeat(np.cumsum(counts) - counts, counts)
            pad = np.zeros((n, int(counts.max())), np.int64)
            mask = np.zeros(pad.shape, bool)
            pad[rep[order], col] = order
            mask[rep[order], col] = True
            self._rep_pad = self._t(pad, torch.int64)
            self._rep_mask = self._t(mask, torch.bool)

    def get_state(self):
        dt = config.np_dtype()
        latents = tuple(
            self._t(np.column_stack([node.output[:, 0] for node in layer]).astype(dt))
            for layer in self.all_layer[:-1])
        params = tuple(
            tuple({'length': self._t(node.length),
                   'nugget': self._t(node.nugget[0]),
                   'scale': self._t(node.scale[0])} if node.type == 'gp' else None
                  for node in layer)
            for layer in self.all_layer)
        return latents, params

    def get_nn_state(self):
        """Per-node Vecchia ordering/neighbour tensors (None for dense
        nodes), cached against the nodes' nn_version counters."""
        fp = tuple(getattr(node, 'nn_version', 0)
                   for layer in self.all_layer for node in layer)
        cached = getattr(self, '_nn_cache', None)
        if cached is not None and cached[0] == fp:
            return cached[1]
        out = []
        for layer, specs in zip(self.all_layer, self.spec):
            lay = []
            for node, sp in zip(layer, specs):
                if sp.vecch:
                    d = {'ord': self._t(node.ord, torch.int64),
                         'rev': self._t(np.argsort(node.ord), torch.int64),
                         'NN': self._t(node.NNarray, torch.int64)}
                    if node.imp_NNarray is not None:
                        d['impNN'] = self._t(node.imp_NNarray, torch.int64)
                    lay.append(d)
                else:
                    lay.append(None)
            out.append(tuple(lay))
        out = tuple(out)
        self._nn_cache = (fp, out)
        return out

    def set_nn_state(self, nn_state):
        """Write a device-computed Vecchia NN structure back into the node
        objects (predictions and persistence read it from there)."""
        for layer, nn_layer in zip(self.all_layer, nn_state):
            for node, d in zip(layer, nn_layer):
                if d is None:
                    continue
                node.ord = tracing.to_host(d['ord'], 'nn_state').numpy()
                node.rev_ord = np.argsort(node.ord)
                node.NNarray = tracing.to_host(d['NN'], 'nn_state').numpy()
                if 'impNN' in d:
                    node.imp_NNarray = tracing.to_host(d['impNN'], 'nn_state').numpy()
                node.nn_version = getattr(node, 'nn_version', 0) + 1

    def supports_device_refresh(self):
        """The device refresh covers random ordering (no custom ord_fun)
        with the exact search or the IVF search; other configurations
        refresh on the host through the imputer."""
        return all(getattr(node, 'ord_fun', None) is None
                   and node.nn_method in ('exact',) + vnn.APPROX_METHODS
                   for layer, specs in zip(self.all_layer, self.spec)
                   for node, sp in zip(layer, specs) if sp.vecch)

    def refresh_nn(self, state, gen):
        """Re-order and rebuild every Vecchia node's NN structure on the
        device (the role of imputation.update_ord_nn, reference
        dgp.py:1388-1389): a random permutation from ``gen`` and a search of
        the length-scaled, reordered inputs, exact or, for a node whose
        ``nn_method`` asks for it at more than 4 * 256 points, the IVF
        search (a cold k-means, as the JAX package's device refresh).
        Same-wiring isotropic nodes of a layer that search the same way
        share one ordering (dgp.py:643-663), but for a node that carries
        the self-excluded neighbour sets of the Hetero exact draw
        (``imp_NNarray``), which are rebuilt with it."""
        with tracing.span('nn.refresh'):
            latents, params = state
            built = {}
            for l, (layer, specs) in enumerate(zip(self.all_layer, self.spec)):
                approx = [sp.vecch and vnn.is_approx(node.nn_method, node.input.shape[0])
                          for node, sp in zip(layer, specs)]
                for k, (node, sp) in enumerate(zip(layer, specs)):
                    if not sp.vecch:
                        built[(l, k)] = None
                        continue
                    needs_imp = node.imp_NNarray is not None
                    share = next(((l, j) for j in range(k)
                                  if (self.spec[l][j].vecch and not needs_imp
                                      and layer[j].imp_NNarray is None
                                      and self.spec[l][j].n_length == 1 and sp.n_length == 1
                                      and self.spec[l][j].input_dim == sp.input_dim
                                      and self.spec[l][j].connect == sp.connect
                                      and layer[j].m == node.m
                                      and approx[j] == approx[k])), None)
                    if share is not None:
                        built[(l, k)] = built[share]
                        continue
                    Xn = self._node_input(l, k, latents)
                    ordv = torch.randperm(Xn.shape[0], generator=gen, device=self.device)
                    Xo = (Xn / params[l][k]['length'])[ordv]
                    m = int(node.m)
                    d = {'ord': ordv, 'rev': torch.argsort(ordv)}
                    if approx[k]:
                        d['NN'], imp = vnn.nn_approx(Xo, m, impute=needs_imp)
                    else:
                        d['NN'] = vnn._nn_ordered_impl(Xo, m)
                        imp = vnn._pred_nn_impl(Xo, Xo, m)[:, 1:] if needs_imp else None
                    if needs_imp:
                        d['impNN'] = imp
                    built[(l, k)] = d
            return tuple(tuple(built[(l, k)] for k in range(len(layer)))
                         for l, layer in enumerate(self.spec))

    def set_state(self, state):
        latents, params = state
        latents = [tracing.to_host(a, 'state').numpy() for a in latents]
        for l, (layer, specs) in enumerate(zip(self.all_layer, self.spec)):
            In = None if l == 0 else latents[l - 1]
            for k, (node, sp) in enumerate(zip(layer, specs)):
                p = params[l][k]
                if p is not None:
                    node.length, node.nugget, node.scale = (
                        np.atleast_1d(tracing.to_host(p[key], 'state').numpy())
                        for key in ('length', 'nugget', 'scale'))
                if l > 0:
                    rows = In[node.rep] if sp.kind != 'gp' and sp.has_rep else In
                    node.input = rows[:, list(sp.input_dim)]
                if l < self.n_layer - 1:
                    node.output = latents[l][:, [k]].copy()

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def _node_input(self, l, k, latents):
        """(..., n, d) input of node (l, k); latents[l - 1] may carry a
        leading candidate axis, and then so does the result."""
        sp = self.spec[l][k]
        In = self.X if l == 0 else latents[l - 1]
        Xn = In[..., list(sp.input_dim)]
        if sp.connect is not None:
            G = self.X[:, list(sp.connect)]
            Xn = torch.cat([Xn, G.expand(Xn.shape[:-2] + G.shape)], dim=-1)
        return Xn

    def _nd(self, on, k, sp):
        """Node k's nugget multipliers from the static tensors of ``on``
        (the engine or a `_Share`), on its device."""
        w_diag = on.w_diag[k] if (sp.is_final and sp.has_rep) else None
        return w_diag if w_diag is not None else torch.ones(
            on.X.shape[0], dtype=self.dtype, device=on.X.device)

    def _gp_loglik(self, l, k, latents, params, nn_state, shares=None):
        """Log-likelihood of node (l, k): a scalar, or (K,) when
        latents[l - 1] carries K candidates.  A Vecchia node goes through
        K4, one launch per share of ``shares`` (by default one share on the
        engine's device), each on its copy of the candidates' ordered
        inputs; a dense node through one batched Cholesky.  The 'ref' prior
        adds its term at the characteristic length of each candidate's
        input."""
        sp = self.spec[l][k]
        p = params[l][k]
        Xn = self._node_input(l, k, latents)
        y = self.y_final[k] if sp.is_final else latents[l][:, k]
        ref_coef = self._t(sp.prior_coef) if sp.prior_name == 'ref' else None
        if not sp.vecch:
            w_diag = self.w_diag[k] if (sp.is_final and sp.has_rep) else None
            return gp_core.log_lik_fixed(Xn, y, p['length'], p['scale'], p['nugget'],
                                         name=sp.name, w_diag=w_diag,
                                         ref_prior_coef=ref_coef,
                                         n_length=sp.n_length, vecch=False)
        shares = shares or _Shares(self, nn_state)
        split = shares.split
        o = nn_state[l][k]['ord']
        nd = self._nd(self, k, sp)

        def part(dev, sl, sh, X_i, y_i, nd_i, ln_i, nug_i):
            return vcore.llik_parts(X_i, y_i, sh.nn[l][k]['NN'], ln_i, nug_i, nd_i,
                                    sp.name, sl.start)
        ll = vcore.llik_total(*split.gathered(
            part, shares.items, *(split.copies(t) for t in (
                Xn[..., o, :], y[o], nd[o], p['length'], p['nugget']))), p['scale'])
        if ref_coef is not None:
            cl = gp_core.compute_cl(Xn, Xn.shape[-2], sp.n_length, True)
            ll = ll + gp_core.log_prior(p['length'], p['nugget'], prior_name='ref',
                                        prior_coef=ref_coef, nugget_est=False, cl=cl)
        return ll

    def _lik_loglik(self, k, latents):
        """Log-likelihood of the final layer's likelihood node k given the
        last hidden layer: a scalar, or (K,) when that layer's latents carry
        K candidates, (K, n, M), all evaluated in one call."""
        sp = self.spec[-1][k]
        f = latents[self.n_layer - 2]
        cands = int(np.prod(f.shape[:-2]))
        tracing.count('lik.evals')
        tracing.count('lik.candidates', cands)
        with tracing.span('sem.lik', name=sp.name, candidates=cands):
            if sp.has_rep:
                f = f[..., self.rep, :]
            f = f[..., list(sp.input_dim)]
            if sp.name == 'Categorical':
                fn = likelihoods.llik_fn(sp.name, num_classes=sp.num_classes,
                                         link=sp.link, robustmax_eps=sp.robustmax_eps)
            else:
                fn = likelihoods.llik_fn(sp.name)
            return fn(f, self.y_lik[k])

    def _upper_loglik(self, l, latents, params, nn_state, shares=None):
        shares = shares or _Shares(self, nn_state)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for k, sp in enumerate(self.spec[l + 1]):
            if sp.kind == 'gp':
                total = total + self._gp_loglik(l + 1, k, latents, params, nn_state,
                                                shares)
            else:
                total = total + self._lik_loglik(k, latents)
        return total

    def _chunk_static(self, sh):
        """Gathered NN views whose source and indices are fixed for a whole
        I-step (global X columns, y_final, the replicate diagonal, the NN
        structure), one stacked gather per Vecchia node, for the points of
        the share ``sh`` from its static tensors, on its device.  Returns
        {(l, k): dict}."""
        cs = {}
        for l, layer in enumerate(self.spec):
            for k, sp in enumerate(layer):
                if not sp.vecch:
                    continue
                ns = sh.nn[l][k]
                ordv = ns['ord']
                rev = torch.flip(ns['NN'], dims=(1,))
                validT = (rev >= 0).T                      # (m1, n)
                safeT = torch.where(validT, rev.T, 0)
                idx_comp = ordv[safeT]                     # src[ordv][safeT]
                stat_cols = ([sh.X[:, c] for c in sp.input_dim] if l == 0 else [])
                if sp.connect is not None:
                    stat_cols += [sh.X[:, c] for c in sp.connect]
                rows = stat_cols + [self._nd(sh, k, sp)]
                if sp.is_final:
                    rows.append(sh.y_final[k])
                src = torch.stack(rows, dim=0)             # (r, n)
                G = src[:, idx_comp].transpose(0, 1)       # (m1, r, n)
                d_s = len(stat_cols)
                cs[(l, k)] = {
                    'ordv': ordv, 'validT': validT, 'safeT': safeT,
                    'idx_comp': idx_comp,
                    'Xg_stat': G[:, :d_s, :],
                    'nd_g': torch.where(validT, G[:, d_s, :], 0.0),
                    'yg_stat': (torch.where(validT, G[:, d_s + 1, :], 0.0)
                                if sp.is_final else None),
                }
        return cs

    def _draw_prior_node(self, l, k, latents, params, nn_state, gen, shares=None):
        """nu ~ N(0, scale * K) for one hidden node (Vecchia ancestral
        sampling, or a dense Cholesky)."""
        with tracing.span('sem.prior_draw'):
            sp = self.spec[l][k]
            p = params[l][k]
            Xn = self._node_input(l, k, latents)
            tracing.count('prior.columns')
            if not sp.vecch:
                K = p['scale'] * kops.k_matrix(Xn, p['length'], p['nugget'], sp.name)
                return linalg.mvn_sample(gen, linalg.safe_cholesky(K))
            tracing.count('prior.passes')
            ns = nn_state[l][k]
            Xo = Xn[ns['ord']]
            parts = self._cond_parts(l, k, Xo, p, shares or _Shares(self, nn_state), False)
            samp = vcore.fmvn_sp(gen, Xo, ns['NN'], p['scale'], p['length'], p['nugget'],
                                 sp.name, parts=parts)
            return samp[ns['rev']]

    def _cond_parts(self, l, k, Xo, p, shares, use_cs):
        """The conditional weights (w, sigma) of node (l, k) at its ordered
        input Xo, one K3 launch per share on its copy of Xo (with ``use_cs``
        from the share's chunk statics), joined on the engine's device."""
        sp = self.spec[l][k]
        split = shares.split

        def part(dev, sl, sh, X_i, ln_i, nug_i):
            pre = None
            if use_cs:
                st = sh.cs[(l, k)]
                # prior draws carry no replicate diagonal: ones on valid lanes
                pre = (st['Xg_stat'], torch.where(st['validT'], 1.0, 0.0).to(self.dtype),
                       st['validT'])
            return vcore.cond_parts(X_i, sh.nn[l][k]['NN'], ln_i, nug_i, sp.name,
                                    pre=pre, start=sl.start)
        parts = split.run(part, shares.items, *(split.copies(t) for t in
                                                (Xo, p['length'], p['nugget'])))
        return vcore.join_weights(split.gather, parts, shares.items[0].nn[l][k]['NN'], Xo)

    def _draw_prior_node_batch(self, l, k, latents, params, nn_state, gen, S,
                               shares=None):
        """S iid prior draws for a node whose input is static within the
        I-step (layer 0): one K3 launch per share of ``shares`` (by default
        one share on the engine's device), from the shares' chunk statics at
        layer 0, and one ancestral pass for all the ESS sweeps of an
        I-step."""
        with tracing.span('sem.prior_draw'):
            sp = self.spec[l][k]
            p = params[l][k]
            Xn = self._node_input(l, k, latents)
            n = Xn.shape[0]
            tracing.count('prior.columns', S)
            if not sp.vecch:
                K = p['scale'] * kops.k_matrix(Xn, p['length'], p['nugget'], sp.name)
                L = linalg.safe_cholesky(K)
                eps = torch.randn((n, S), generator=gen, dtype=self.dtype,
                                  device=self.device)
                return (L @ eps).T
            tracing.count('prior.passes')
            ns = nn_state[l][k]
            parts = self._cond_parts(l, k, Xn[ns['ord']], p, shares or _Shares(self, nn_state),
                                     l == 0)
            w, sigma, idx_asc, _ = vcore.cond_weights(
                Xn[ns['ord']], ns['NN'], p['length'], p['nugget'], sp.name, parts=parts)
            eps = (torch.randn((S, n), generator=gen, dtype=self.dtype,
                               device=self.device)
                   * torch.sqrt(p['scale']) * sigma[None, :])
            samp = vcore.ancestral_sample(eps, w, idx_asc)
            return samp[:, ns['rev']]

    def _ess_block_layer(self, l, latents, views, params, nn_state, gens, shares,
                         pre_nu=None, s=None, plan=None):
        """One block ESS transition of layer l.  ``plan`` (the layer's angle
        plans) and the layer's views are lists with one entry per share of
        ``shares``, each on its share's device."""
        gen, host_gen = gens
        cols = []
        for k in range(len(self.spec[l])):
            if pre_nu is not None and (l, k) in pre_nu:
                cols.append(pre_nu[(l, k)][s])
            else:
                cols.append(self._draw_prior_node(l, k, latents, params,
                                                  nn_state, gen, shares))
        nu = torch.stack(cols, dim=1)
        f = latents[l]

        def log_lik(fp):
            lat2 = latents[:l] + (fp,) + latents[l + 1:]
            return self._upper_loglik(l, lat2, params, nn_state, shares)

        if plan is None:
            # the candidates of a round as one batch: K4 with a candidate
            # axis for Vecchia upper nodes, one batched Cholesky for dense
            def log_lik_angles(cosv, sinv):
                c = torch.as_tensor(cosv, dtype=self.dtype, device=self.device)
                sn = torch.as_tensor(sinv, dtype=self.dtype, device=self.device)
                return log_lik(c[:, None, None] * f + sn[:, None, None] * nu)

            with tracing.span('sem.ess', layer=l, route='block', cols=f.shape[1]):
                f_new = ess_update(host_gen, f, nu, log_lik,
                                   log_lik_angles=log_lik_angles,
                                   spec=config.ess_spec(f.shape[0]))
            return latents[:l] + (f_new,) + latents[l + 1:], views

        # angle path: gathered block views are maintained across sweeps,
        # each share's on its device
        A_lists = views[l]
        B_lists = [[nd_['B_all'][s] if nd_['B_all'] is not None
                    else self._gather_latent_view(nd_, nu_i) for nd_ in p['nodes']]
                   for p, nu_i in zip(plan, shares.split.copies(nu))]
        ll = self._plan_ll(plan, l, latents, nu, A_lists, B_lists, shares)
        with tracing.span('sem.ess', layer=l, route='block', cols=f.shape[1]):
            f_new, (c_a, s_a) = ess_update(host_gen, f, nu, log_lik,
                                           log_lik_angles=ll,
                                           spec=config.ess_spec(f.shape[0]),
                                           return_angle=True)
        new_A = [tuple(c_a * A + s_a * B for A, B in zip(Al, Bl))
                 for Al, Bl in zip(A_lists, B_lists)]
        return latents[:l] + (f_new,) + latents[l + 1:], views[:l] + (new_A,) + views[l + 1:]

    def _angle_applicable(self, l):
        """The angle evaluator applies when every upper GP node is Vecchia,
        carries no input-dependent ('ref') prior term and has blocks that
        K2 takes (`cv.use_kernel`); likelihood nodes above do not matter."""
        for j, sp in enumerate(self.spec[l + 1]):
            if sp.kind != 'gp':
                continue
            if not sp.vecch or sp.prior_name == 'ref':
                return False
            if not cv.use_kernel("K2", int(self.all_layer[l + 1][j].m) + 1, sp.D,
                                 dtype=self.dtype):
                return False
        return True

    @staticmethod
    def _gather_latent_view(nd_, M):
        """(m1, d, n) view of M's node-input columns: ordered, gathered by
        the node's NN sets, length-scaled, zero on invalid lanes and global
        dims."""
        Ms = (M[nd_['ordv']][:, nd_['cols']] / nd_['s_lat']).T
        G = Ms[:, nd_['safeT']].transpose(0, 1)
        G = torch.where(nd_['validT'][:, None, :], G, 0.0)
        if nd_['dg']:
            m1, _, n = G.shape
            G = torch.cat([G, G.new_zeros((m1, nd_['dg'], n))], dim=1)
        return G

    def _build_angle_plan(self, l, latents, params, sh, pre_nu, S):
        """Per-I-step static views for layer l's angle evaluator (or None).

        ESS candidates are linear in (f, nu), so each upper node's gathered,
        length-scaled blocks decompose as cos*A + sin*B + C.  C (global dims
        + sentinels), the block diagonals and -- for final nodes -- the
        gathered targets are fixed for the I-step; the A views start here
        and are maintained across sweeps by the accepted-angle combine, and
        layer-0 nu views are gathered for all S sweeps at once.  The views
        cover the points of the share ``sh``, built from its chunk statics
        and the state (latents, params) on its device."""
        if not (self.block and not self._layer_is_exact(l)
                and config.ess_spec(latents[l].shape[0]) > 1
                and self._angle_applicable(l)):
            return None
        dt = self.dtype
        dev = latents[l].device
        nodes = []
        for j, sp in enumerate(self.spec[l + 1]):
            if sp.kind != 'gp':
                continue
            p = params[l + 1][j]
            st = sh.cs[(l + 1, j)]
            dl = len(sp.input_dim)
            dg = len(sp.connect) if sp.connect is not None else 0
            length_full = torch.broadcast_to(p['length'], (dl + dg,))
            ordv, validT, safeT = st['ordv'], st['validT'], st['safeT']
            m1, n_c = safeT.shape
            sent = cv.sentinels(n_c, m1, dt, dev, sh.sl.start)
            nd_ = dict(name=sp.name, j=j, dl=dl, dg=dg, cols=list(sp.input_dim),
                       ordv=ordv, safeT=safeT, validT=validT,
                       s_lat=length_full[:dl], scale=p['scale'],
                       is_final=sp.is_final)
            C = torch.zeros((m1, dl, n_c), dtype=dt, device=dev)
            if dg:
                C = torch.cat([C, st['Xg_stat'] / length_full[dl:, None]], dim=1)
            nd_['C'] = torch.where(validT[:, None, :], C, sent[:, None, :])
            nd_['diag'] = torch.where(
                validT, 1.0 + p['nugget'] * st['nd_g'] + vcore._f32_jitter(dt), 1.0)
            nd_['yg'] = st['yg_stat'] if sp.is_final else None
            nd_['B_all'] = None
            if pre_nu is not None and all((l, c) in pre_nu for c in nd_['cols']):
                # one batched gather for the A0 view and all S nu views
                nu_all = torch.stack([pre_nu[(l, c)] for c in nd_['cols']],
                                     dim=2)                    # (S, n, dl)
                lat0 = latents[l][:, nd_['cols']][None]        # (1, n, dl)
                allv = torch.cat([lat0, nu_all], dim=0)
                Ms = torch.movedim(allv / nd_['s_lat'], 1, 2)  # (S+1, dl, n)
                G = torch.movedim(Ms[:, :, st['idx_comp']], 2, 1)  # (S+1, m1, dl, n)
                G = torch.where(validT[None, :, None, :], G, 0.0)
                if dg:
                    G = torch.cat([G, G.new_zeros((S + 1, m1, dg, n_c))], dim=2)
                nd_['A0'] = G[0]
                nd_['B_all'] = G[1:]
            else:
                nd_['A0'] = self._gather_latent_view(nd_, latents[l])
            nodes.append(nd_)
        lik_nodes = [j for j, sp in enumerate(self.spec[l + 1]) if sp.kind != 'gp']
        return dict(nodes=nodes, lik=lik_nodes)

    def _plan_ll(self, plans, l, latents, nu, A_lists, B_lists, shares):
        """Angle evaluator from maintained views: (cos (K,), sin (K,)) ->
        (K,) float64 upper-layer log-liks of the candidates cos*f + sin*nu,
        one K2 launch per upper GP node and share of ``shares`` (``plans``,
        ``A_lists`` and ``B_lists`` hold one entry per share, and the
        shares' states are current), and one call on all K candidates per
        likelihood node."""
        lats = [st[0] for st in shares.states]
        plan = plans[0]

        def k2(j, p, A, B, lat, cosv, sinv):
            nd_ = p['nodes'][j]
            if nd_['yg'] is not None:
                yg = nd_['yg']
            else:
                y = lat[l + 1][:, nd_['j']]
                yg = torch.where(nd_['validT'], y[nd_['ordv']][nd_['safeT']], 0.0)
            return cv.block_loglik_multi_t(A[j], B[j], nd_['C'], yg, nd_['diag'],
                                           cosv, sinv, name=nd_['name'], dl=nd_['dl'])

        def ll(cosv, sinv):
            cosv = torch.as_tensor(cosv, dtype=self.dtype, device=self.device)
            sinv = torch.as_tensor(sinv, dtype=self.dtype, device=self.device)
            total = torch.zeros(cosv.shape[0], dtype=torch.float64,
                                device=self.device)
            angles = [shares.split.copies(cosv), shares.split.copies(sinv)]
            for j, nd_ in enumerate(plan['nodes']):
                ld, q = shares.split.gathered(lambda dev, sl, *a, j=j: k2(j, *a),
                                              plans, A_lists, B_lists, lats, *angles)
                total = total - 0.5 * (linalg.sum64(ld, dim=1)
                                       + linalg.sum64(q, dim=1)
                                       / nd_['scale'].to(torch.float64))
            if plan['lik']:
                cand = cosv[:, None, None] * latents[l] + sinv[:, None, None] * nu
                lat2 = latents[:l] + (cand,) + latents[l + 1:]
                for j in plan['lik']:
                    total = total + self._lik_loglik(j, lat2)
            return total

        return ll

    # -- Hetero exact conditional posterior ----------------------------
    def _site_sum(self, v):
        """Sum of the per-observation values v over each site's replicates,
        (n,); in a fixed order (see `_extract_data`)."""
        return torch.where(self._rep_mask, v[self._rep_pad], 0.0).sum(dim=1)

    def _het_site_noise(self, logvar, y, has_rep):
        """Per-site noise variance and effective observation of a Hetero
        node from the per-site log-variance column: with replicates the
        precision-weighted ones (likelihood_class.post_het2)."""
        if not has_rep:
            return torch.exp(logvar), y
        invG = torch.exp(-logvar[self.rep])
        d = 1.0 / self._site_sum(invG)
        return d, d * self._site_sum(invG * y)

    def _post_het(self, v, Gamma, y, gen, normals=None):
        """One draw of the Hetero mean from its exact Gaussian conditional
        (likelihood_class.post_het1/post_het2): prior covariance v (n, n),
        per-site noise variances Gamma and (effective) observations y, both
        (n,) (`_het_site_noise`).  ``normals`` (n, 2) replaces the draw from
        ``gen``."""
        N = v.shape[0]
        L = linalg.safe_cholesky(v + torch.diag(Gamma))
        L1 = linalg.safe_cholesky(v)

        def solve(b):
            return linalg.cho_solve(L, b[:, None])[:, 0]

        mu = v @ solve(y)
        sd = normals if normals is not None else torch.randn(
            (N, 2), generator=gen, dtype=self.dtype, device=self.device)
        u = L1 @ sd[:, 0]
        w = torch.sqrt(Gamma) * sd[:, 1]
        return mu + u - v @ solve(u + w)

    def _exact_draw(self, l, k, usp, j, latents, params, nn_state, gen):
        """The exact Gibbs draw of hidden node (l, k), the mean under the
        Hetero node j: through the stacked Vecchia factor when the node
        carries its self-excluded neighbour sets, dense otherwise."""
        sp = self.spec[l][k]
        ns = nn_state[l][k]
        kind = 'vecchia' if sp.vecch and ns is not None and 'impNN' in ns else 'dense'
        tracing.count('exact_draws.' + kind)
        with tracing.span('sem.exact_draw', layer=l, kind=kind):
            p = params[l][k]
            Xn = self._node_input(l, k, latents)
            Gamma, y_eff = self._het_site_noise(latents[l][:, usp.input_dim[1]],
                                                self.y_lik[j][:, 0], usp.has_rep)
            if kind == 'vecchia':
                o = ns['ord']
                return vcore.post_het_vecch(gen, Xn[o], ns['impNN'], Gamma[o], y_eff[o],
                                            p['scale'], p['length'], p['nugget'],
                                            sp.name)[ns['rev']]
            v = p['scale'] * kops.k_matrix(Xn, p['length'], p['nugget'], sp.name)
            return self._post_het(v, Gamma, y_eff, gen)

    def _nodewise_loglik(self, l, k, linked, F, latents, params, nn_state, shares=None):
        """Log-likelihood of the upper nodes ``linked`` to hidden node (l, k)
        with its column set to F: (n,) -> a scalar, (K, n) -> (K,); over
        the shares as `_gp_loglik`."""
        shares = shares or _Shares(self, nn_state)
        lat = latents[l].expand(F.shape[:-1] + latents[l].shape).clone()
        lat[..., k] = F
        lat2 = latents[:l] + (lat,) + latents[l + 1:]
        total = torch.zeros(F.shape[:-1], dtype=torch.float64, device=self.device)
        for j in linked:
            if self.spec[l + 1][j].kind == 'gp':
                total = total + self._gp_loglik(l + 1, j, lat2, params, nn_state,
                                                shares)
            else:
                total = total + self._lik_loglik(j, lat2)
        return total

    def _ess_nodewise_layer(self, l, latents, params, nn_state, gens, shares,
                            pre_nu=None, s=None):
        """One transition per node of layer l against the upper nodes wired
        to it: the exact draw for the mean of a Hetero node, else ESS, whose
        speculative candidates of a round go through one K4 launch per
        linked upper GP node and one call per linked likelihood node."""
        gen, host_gen = gens
        for k in range(len(self.spec[l])):
            linked = [j for j, usp in enumerate(self.spec[l + 1])
                      if k in usp.input_dim]
            usp = self.spec[l + 1][linked[0]] if len(linked) == 1 else None
            if (usp is not None and usp.kind != 'gp' and usp.exact_post_idx is not None
                    and usp.input_dim.index(k) in list(np.atleast_1d(usp.exact_post_idx))):
                f = self._exact_draw(l, k, usp, linked[0], latents, params, nn_state, gen)
                lat = latents[l].clone()
                lat[:, k] = f
                latents = latents[:l] + (lat,) + latents[l + 1:]
                continue
            if pre_nu is not None and (l, k) in pre_nu:
                nu = pre_nu[(l, k)][s]
            else:
                nu = self._draw_prior_node(l, k, latents, params, nn_state, gen, shares)
            f = latents[l][:, k]

            def log_lik(F, l=l, k=k, linked=linked):
                return self._nodewise_loglik(l, k, linked, F, latents, params, nn_state,
                                             shares)

            def log_lik_angles(cosv, sinv, f=f, nu=nu, log_lik=log_lik):
                c = torch.as_tensor(cosv, dtype=self.dtype, device=self.device)
                sn = torch.as_tensor(sinv, dtype=self.dtype, device=self.device)
                return log_lik(c[:, None] * f + sn[:, None] * nu)

            with tracing.span('sem.ess', layer=l, route='nodewise'):
                f_new = ess_update(host_gen, f, nu, log_lik,
                                   log_lik_angles=log_lik_angles,
                                   spec=config.ess_spec(f.shape[0]))
            lat = latents[l].clone()
            lat[:, k] = f_new
            latents = latents[:l] + (lat,) + latents[l + 1:]
        return latents

    def _layer_is_exact(self, l):
        """A layer under a likelihood node with an exact conditional (the
        Hetero mean) goes node by node even with ``block=True``."""
        return any(sp.kind != 'gp' and sp.exact_post_idx is not None
                   for sp in self.spec[l + 1])

    def _sweep(self, latents, views, params, nn_state, gens, shares, pre_nu=None,
               s=None, plans=None):
        for l in range(self.n_layer - 1):
            if not self.block or self._layer_is_exact(l):
                latents = self._ess_nodewise_layer(l, latents, params, nn_state,
                                                   gens, shares, pre_nu, s)
            else:
                plan = plans[l] if plans is not None else None
                latents, views = self._ess_block_layer(l, latents, views, params,
                                                       nn_state, gens, shares, pre_nu, s,
                                                       plan)
            shares.sync(latents, params)
        return latents, views

    def _share_plans(self, l, pre_nu, S, shares):
        """Layer l's angle plans, one per share, each built on its share's
        device from the share's copy of the state and of ``pre_nu``."""
        pn = ([None] * len(shares.split) if not pre_nu else
              [dict(zip(pre_nu, vs)) for vs in zip(*(shares.split.copies(v)
                                                      for v in pre_nu.values()))])
        plans = shares.split.run(
            lambda dev, sl, sh, st, pn_i: self._build_angle_plan(l, st[0], st[1], sh, pn_i, S),
            shares.items, shares.states, pn)
        return None if plans[0] is None else plans

    def _i_step(self, latents, params, nn_state, gens, burnin, shares=None):
        """One I-step: ``burnin`` + 1 ESS sweeps over the shares of
        ``shares`` (by default one share on the engine's device)."""
        with tracing.span('sem.istep'):
            S = burnin + 1
            shares = shares or _Shares(self, nn_state)
            shares.sync(latents, params)
            # layer-0 prior draws are iid across sweeps (their inputs are the
            # fixed global X), so draw them all at once
            pre_nu = {}
            if self.n_layer > 1:
                for k in range(len(self.spec[0])):
                    pre_nu[(0, k)] = self._draw_prior_node_batch(
                        0, k, latents, params, nn_state, gens[0], S, shares)
            plans = tuple(self._share_plans(l, pre_nu if l == 0 else None, S, shares)
                          for l in range(self.n_layer - 1))
            views = tuple(None if ps is None else
                          [tuple(nd_['A0'] for nd_ in plan['nodes']) for plan in ps]
                          for ps in plans)
            for s in range(S):
                latents, views = self._sweep(latents, views, params, nn_state, gens, shares,
                                             pre_nu, s, plans)
            return latents

    # -- M-step ---------------------------------------------------------
    def _node_bounds(self, sp, p_max):
        big = float(torch.finfo(self.dtype).max / 4)
        p_k = sp.n_length + (1 if sp.nugget_est else 0)
        lb = np.full(p_max, -big)
        ub = np.full(p_max, big)
        if sp.bds is not None:
            lb[:sp.n_length] = np.log(sp.bds[0]) if sp.bds[0] > 0 else -big
            ub[:sp.n_length] = np.log(sp.bds[1])
        elif sp.prior_name == 'ref':
            ub[:sp.n_length] = 13.0
        if sp.nugget_est:
            lb[p_k - 1] = np.log(1e-8)
            ub[p_k - 1] = big
        lb[p_k:] = 0.0  # frozen padded lanes
        ub[p_k:] = 0.0
        return self._t(lb), self._t(ub)

    def _node_operands(self, l, k, sp, latents, params, d_max, p_max):
        """Stackable operands of GP node (l, k) for the batched M-step:
        (op dict, lt0, lb, ub, maxfun).  A dense node brings its zero-padded
        input, target and replicate diagonal; a Vecchia node's blocks are
        built per share (`_vecch_operands`)."""
        dt = self.dtype
        p = params[l][k]
        d_k = sp.D
        has_rep = sp.is_final and sp.has_rep
        p_k = sp.n_length + (1 if sp.nugget_est else 0)

        # tying matrix: node params (p_max) -> lanes (d_max lengths + nugget)
        A = np.zeros((d_max + 1, p_max))
        if sp.n_length == 1:
            A[:d_k, 0] = 1.0
        else:
            for t in range(sp.n_length):
                A[t, t] = 1.0
        if sp.nugget_est:
            A[d_max, sp.n_length] = 1.0
        b = torch.zeros(d_max + 1, dtype=dt, device=self.device)
        if not sp.nugget_est:
            b[-1] = torch.log(p['nugget'])
        param_mask = np.zeros(p_max)
        param_mask[:p_k] = 1.0
        f64 = dict(dtype=torch.float64, device=self.device)
        op = {
            'A': self._t(A), 'b': b, 'param_mask': self._t(param_mask),
            'prior_id': torch.tensor(mstep.PRIOR_ID.get(sp.prior_name, 0),
                                     device=self.device),
            'prior_coef': self._t(sp.prior_coef if sp.prior_coef is not None
                                  else np.zeros(2)),
            'scale_est': torch.tensor(sp.scale_est, device=self.device),
            'nug_est_f': torch.tensor(1.0 if sp.nugget_est else 0.0, **f64),
            'sum_res': torch.tensor(self.sum_res[k] if has_rep else 0.0, **f64),
            'n_orig': torch.tensor(self.n_orig if has_rep else float(self.n), **f64),
            'fixed_scale64': p['scale'].to(torch.float64),
            'cl': torch.zeros(d_max, dtype=dt, device=self.device),
        }
        if sp.prior_name == 'ref' or not sp.vecch:
            Xn = self._node_input(l, k, latents)
        if sp.prior_name == 'ref':
            cl = gp_core.compute_cl(Xn, self.n, sp.n_length, sp.vecch)
            op['cl'][:cl.shape[0]] = cl
        if not sp.vecch:
            op.update(X=torch.nn.functional.pad(Xn, (0, d_max - d_k)),
                      y=self.y_final[k] if sp.is_final else latents[l][:, k],
                      w_diag=self._nd(self, k, sp))
        lt0 = torch.log(p['length'])
        if sp.nugget_est:
            lt0 = torch.cat([lt0, torch.log(p['nugget'])[None]])
        lt0 = torch.nn.functional.pad(lt0, (0, p_max - p_k))
        lb, ub = self._node_bounds(sp, p_max)
        # the reference budget (kernel_class.py:542), capped
        maxfun = min(max(30, 20 + 5 * sp.D), config.MSTEP_MAXFUN_CAP)
        return op, lt0, lb, ub, maxfun

    def _vecch_operands(self, l, k, sp, latents, d_max, cs):
        """A Vecchia node's M-step blocks in the kernels' layout, for the
        points and on the device of the chunk statics ``cs``: a dict of
        Xg_raw, yg, nug_g and valid."""
        dt = self.dtype
        d_k = sp.D
        st = cs[(l, k)]
        valid = st['validT']
        m1, n = valid.shape
        dyn_rows = [latents[l - 1][:, c] for c in sp.input_dim] if l > 0 else []
        if not sp.is_final:
            dyn_rows.append(latents[l][:, k])
        Gd = (torch.stack(dyn_rows, dim=0)[:, st['idx_comp']].transpose(0, 1)
              if dyn_rows else None)                       # (m1, r, n)
        parts = [Gd[:, :len(sp.input_dim)]] if l > 0 else []
        parts.append(st['Xg_stat'])
        if d_k < d_max:
            parts.append(torch.zeros((m1, d_max - d_k, n), dtype=dt, device=valid.device))
        return dict(Xg_raw=torch.cat(parts, dim=1),
                    yg=st['yg_stat'] if sp.is_final else torch.where(valid, Gd[:, -1], 0.0),
                    nug_g=st['nd_g'], valid=valid)

    def _group_blocks(self, es, d_max, shares):
        """The M-step blocks of the Vecchia group ``es`` ((l, k, spec)
        triples): per share of ``shares``, the group's stacked Xg_raw, yg,
        nug_g and valid, built on its device from its copy of the latents
        (the shares' states are current)."""
        def blocks(dev, sl, sh, st):
            per = [self._vecch_operands(l, k, sp, st[0], d_max, sh.cs) for l, k, sp in es]
            return {key: torch.stack([o[key] for o in per]) for key in per[0]}
        return shares.split.run(blocks, shares.items, shares.states)

    def _m_step(self, latents, params, nn_state, shares=None):
        """Per-node bounded L-BFGS of every GP node, one batched
        optimisation per (mode, kernel name, m + 1) group.  A Vecchia
        group's blocks are built on the device of every share of ``shares``
        (by default one share on the engine's device) from its copy of the
        latents, and each objective evaluation launches K1 (or the route)
        per share."""
        with tracing.span('sem.mstep'):
            shares = shares or _Shares(self, nn_state)
            shares.sync(latents, params)
            groups = {}
            for l, layer in enumerate(self.spec):
                for k, sp in enumerate(layer):
                    if sp.kind != 'gp':
                        continue
                    key = (('vecch', sp.name, nn_state[l][k]['NN'].shape[1]) if sp.vecch
                           else ('dense', sp.name, 0))
                    groups.setdefault(key, []).append((l, k, sp))
            results = {}
            for (mode, name, _m1), es in groups.items():
                d_max = max(sp.D for _, _, sp in es)
                p_max = max(sp.n_length + (1 if sp.nugget_est else 0) for _, _, sp in es)
                built = [self._node_operands(l, k, sp, latents, params, d_max, p_max)
                         for l, k, sp in es]
                ops = {key: torch.stack([b[0][key] for b in built]) for key in built[0][0]}
                lt0, lb, ub = (torch.stack([b[i] for b in built]) for i in (1, 2, 3))
                parts = self._group_blocks(es, d_max, shares) if mode == 'vecch' else None
                lt, scale, ok = mstep.run_group(
                    ops, lt0, lb, ub, [b[4] for b in built], name=name, mode=mode,
                    d_max=d_max, n=self.n,
                    has_ref=any(sp.prior_name == 'ref' for _, _, sp in es),
                    parts=parts, split=shares.split)
                for i, (l, k, _) in enumerate(es):
                    results[(l, k)] = (lt[i], scale[i], ok[i], lt0[i])

            new_params = []
            for l, layer in enumerate(self.spec):
                layer_p = []
                for k, sp in enumerate(layer):
                    if sp.kind != 'gp':
                        layer_p.append(None)
                        continue
                    p = params[l][k]
                    lt, scale, ok, lt0 = results[(l, k)]
                    lt = torch.where(ok, lt, lt0)
                    scale = torch.where(ok & sp.scale_est, scale.to(p['scale'].dtype),
                                        p['scale'])
                    nugget = torch.exp(lt[sp.n_length]) if sp.nugget_est else p['nugget']
                    layer_p.append({'length': torch.exp(lt[:sp.n_length]),
                                    'nugget': nugget, 'scale': scale})
                new_params.append(tuple(layer_p))
            return tuple(new_params)

    def _para_vector(self, params):
        """Per GP node: (scale, lengths..., nugget), the para_path row."""
        return tuple(torch.cat([p['scale'][None], p['length'], p['nugget'][None]])
                     for layer_p in params for p in layer_p if p is not None)

    def _r2_vector(self, latents):
        """R^2 of the least-squares fit global input -> input, per GP node
        with a global connection below the first layer, from ridge-
        regularised normal equations solved by Cholesky."""
        out = []
        for l in range(1, self.n_layer):
            for sp in self.spec[l]:
                if sp.kind != 'gp' or sp.connect is None:
                    continue
                G = self.X[:, list(sp.connect)]
                G1 = torch.cat([G, torch.ones((G.shape[0], 1), dtype=self.dtype,
                                              device=self.device)], dim=1)
                In = latents[l - 1][:, list(sp.input_dim)]
                gtg = G1.T @ G1
                eps = 1e-8 * torch.trace(gtg) / gtg.shape[0]
                A = gtg + eps * torch.eye(gtg.shape[0], dtype=self.dtype,
                                          device=self.device)
                chol = torch.linalg.cholesky_ex(A).L
                beta = torch.cholesky_solve(G1.T @ In, chol)
                resid = torch.sum((In - G1 @ beta) ** 2, dim=0)
                out.append(1.0 - resid / (In.shape[0] * torch.var(In, dim=0,
                                                                  correction=0)))
        return tuple(out)

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def sample(self, state, gen, host_gen, burnin=0):
        """(burnin+1) ESS-within-Gibbs sweeps over all hidden layers.
        ``gen`` draws the device-side normals; ``host_gen`` (a CPU
        generator) the ESS uniforms."""
        latents, params = state
        latents = self._i_step(latents, params, self.get_nn_state(), (gen, host_gen),
                               burnin)
        return latents, params

    def train_chunk(self, state, gens, n_iters, ess_burn, nn_state=None, mesh=None):
        """Run ``n_iters`` SEM iterations (I-step, R^2, M-step) from
        ``state``.  ``gens`` is (device generator, CPU generator for the ESS
        uniforms); ``nn_state`` may carry a device-refreshed NN structure
        (see refresh_nn) and by default is read from the node objects.  The
        per-point kernel calls run over the shares of ``mesh``
        (`parallel.mesh.model_mesh`; by default the engine's device alone),
        with the same results on any mesh (`_Shares`).
        Returns (state, para, r2): per GP node an (n_iters, 2 + p) tensor of
        para_path rows, and per globally connected node an (n_iters, d)
        tensor of R^2 values."""
        with tracing.span('sem.chunk'):
            if nn_state is None:
                nn_state = self.get_nn_state()
            latents, params = state
            shares = _Shares(self, nn_state, mesh)
            paras, r2s = [], []
            for _ in range(n_iters):
                latents = self._i_step(latents, params, nn_state, gens, ess_burn, shares)
                r2s.append(self._r2_vector(latents))
                params = self._m_step(latents, params, nn_state, shares)
                paras.append(self._para_vector(params))
            para = tuple(torch.stack(col) for col in zip(*paras))
            r2 = tuple(torch.stack(col) for col in zip(*r2s))
            return (latents, params), para, r2
