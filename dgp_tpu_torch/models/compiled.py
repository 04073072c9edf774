"""DGP sampling engine: the ESS-within-Gibbs I-step on tensors; the
counterpart of the sampling part of `dgp_tpu/models/compiled.py`.

The DGP's dynamic state is

    state = (latents, params)
      latents : tuple over hidden layers of (n, M_l) tensors
      params  : tuple over layers of tuples of per-GP-node
                {'length': (p,), 'nugget': (), 'scale': ()} tensors

plus, under the Vecchia approximation, a per-node neighbour structure

    nn_state : tuple over layers of tuples of {'ord', 'rev', 'NN'}

all on the engine's device.  The JAX package traces one I-step into a
single program; here it runs eagerly, with the ESS rounds' host checks as
the only synchronisations.

Where every upper GP node is Vecchia with no 'ref' prior, the ESS
candidates of a layer are evaluated through maintained angle views
(`_build_angle_plan` / `_plan_ll`) by the K2 kernel, and the prior draws go
through the K3 kernel (`vecchia.core.cond_weights`) -- on every device; on
the CPU the kernel wrappers run their plain versions.

Not ported yet (each raises NotImplementedError): the M-step and
`train_chunk` (ROADMAP "training"), likelihood nodes and dense GP nodes
(ROADMAP O1/O2), node-wise ESS (block=False) and 'ref' priors.
"""
import numpy as np
import torch

from .. import config
from ..ess import ess_update
from ..ops import cuda_vecchia as cv
from ..ops import linalg
from ..vecchia import core as vcore


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to dgp_tpu_torch yet "
                               f"(ROADMAP.md, {item})")


class NodeSpec:
    """Static description of one GP node."""

    def __init__(self, obj, layer, n_layer):
        self.kind = obj.type
        if self.kind != 'gp':
            raise _not_ported("likelihood nodes", "O2")
        self.name = obj.name
        self.input_dim = tuple(int(i) for i in obj.input_dim)
        self.connect = None if getattr(obj, 'connect', None) is None else \
            tuple(int(i) for i in obj.connect)
        self.is_final = layer == n_layer - 1
        self.prior_name = obj.prior_name
        self.has_rep = obj.W_diag is not None
        self.vecch = bool(getattr(obj, 'vecch', False))


class CompiledDGP:
    """ESS-within-Gibbs imputation for one DGP structure on one device."""

    def __init__(self, all_layer, block=True, device=None):
        if not block:
            raise _not_ported("node-wise ESS (block=False)", "training")
        self.all_layer = all_layer
        self.n_layer = len(all_layer)
        self.block = block
        self.device = config.resolve_device(device)
        self.spec = [[NodeSpec(node, l, self.n_layer) for node in layer]
                     for l, layer in enumerate(all_layer)]
        if not all(sp.vecch for layer in self.spec for sp in layer):
            raise _not_ported("dense (non-Vecchia) GP nodes", "O1")
        self.dtype = config.default_dtype()
        self._extract_data()

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
        self.y_final, self.w_diag = [], []
        for node, sp in zip(self.all_layer[-1], self.spec[-1]):
            self.y_final.append(self._t(node.output[:, 0]))
            self.w_diag.append(self._t(node.W_diag) if sp.has_rep else None)

    def get_state(self):
        dt = config.np_dtype()
        latents = tuple(
            self._t(np.column_stack([node.output[:, 0] for node in layer]).astype(dt))
            for layer in self.all_layer[:-1])
        params = tuple(
            tuple({'length': self._t(node.length),
                   'nugget': self._t(node.nugget[0]),
                   'scale': self._t(node.scale[0])} for node in layer)
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
                    lay.append({'ord': self._t(node.ord, torch.int64),
                                'rev': self._t(np.argsort(node.ord), torch.int64),
                                'NN': self._t(node.NNarray, torch.int64)})
                else:
                    lay.append(None)
            out.append(tuple(lay))
        out = tuple(out)
        self._nn_cache = (fp, out)
        return out

    def set_state(self, state):
        latents, params = state
        latents = [a.cpu().numpy() for a in latents]
        for l, (layer, specs) in enumerate(zip(self.all_layer, self.spec)):
            In = None if l == 0 else latents[l - 1]
            for k, (node, sp) in enumerate(zip(layer, specs)):
                p = params[l][k]
                node.length = np.atleast_1d(p['length'].cpu().numpy())
                node.nugget = np.atleast_1d(p['nugget'].cpu().numpy())
                node.scale = np.atleast_1d(p['scale'].cpu().numpy())
                if l > 0:
                    node.input = In[:, list(sp.input_dim)]
                if l < self.n_layer - 1:
                    node.output = latents[l][:, [k]].copy()

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def _node_input(self, l, k, latents):
        sp = self.spec[l][k]
        In = self.X if l == 0 else latents[l - 1]
        Xn = In[:, list(sp.input_dim)]
        if sp.connect is not None:
            Xn = torch.cat([Xn, self.X[:, list(sp.connect)]], dim=1)
        return Xn

    def _nd(self, k, sp, n):
        w_diag = self.w_diag[k] if (sp.is_final and sp.has_rep) else None
        return w_diag if w_diag is not None else torch.ones(
            n, dtype=self.dtype, device=self.device)

    def _gp_loglik(self, l, k, latents, params, nn_state):
        sp = self.spec[l][k]
        if sp.prior_name == 'ref':
            raise _not_ported("the 'ref' prior", "O1")
        if self.device.type != 'cpu':
            # the JAX package runs this through kernel K4 on its device
            raise _not_ported("the per-node Vecchia log-likelihood on the "
                              "card (kernel K4)", "T2")
        p = params[l][k]
        Xn = self._node_input(l, k, latents)
        y = self.y_final[k] if sp.is_final else latents[l][:, k]
        ns = nn_state[l][k]
        nd = self._nd(k, sp, Xn.shape[0])
        o = ns['ord']
        return vcore.vecchia_llik(Xn[o], y[o], ns['NN'], p['scale'],
                                  p['length'], p['nugget'], nd[o], sp.name)

    def _upper_loglik(self, l, latents, params, nn_state):
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for k in range(len(self.spec[l + 1])):
            total = total + self._gp_loglik(l + 1, k, latents, params, nn_state)
        return total

    def _chunk_static(self, nn_state):
        """Gathered NN views whose source and indices are fixed for a whole
        I-step (global X columns, y_final, the replicate diagonal, the NN
        structure), one stacked gather per Vecchia node.  Returns
        {(l, k): dict}."""
        cs = {}
        for l, layer in enumerate(self.spec):
            for k, sp in enumerate(layer):
                if not sp.vecch:
                    continue
                ns = nn_state[l][k]
                ordv = ns['ord']
                rev = torch.flip(ns['NN'], dims=(1,))
                validT = (rev >= 0).T                      # (m1, n)
                safeT = torch.where(validT, rev.T, 0)
                idx_comp = ordv[safeT]                     # src[ordv][safeT]
                n = ordv.shape[0]
                stat_cols = ([self.X[:, c] for c in sp.input_dim] if l == 0 else [])
                if sp.connect is not None:
                    stat_cols += [self.X[:, c] for c in sp.connect]
                rows = stat_cols + [self._nd(k, sp, n)]
                if sp.is_final:
                    rows.append(self.y_final[k])
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

    def _draw_prior_node(self, l, k, latents, params, nn_state, gen):
        """nu ~ N(0, scale * K) for one hidden Vecchia node."""
        sp = self.spec[l][k]
        if not sp.vecch:
            raise _not_ported("dense prior draws", "O1")
        p = params[l][k]
        Xn = self._node_input(l, k, latents)
        ns = nn_state[l][k]
        samp = vcore.fmvn_sp(gen, Xn[ns['ord']], ns['NN'], p['scale'],
                             p['length'], p['nugget'], sp.name)
        return samp[ns['rev']]

    def _draw_prior_node_batch(self, l, k, latents, params, nn_state, gen, S,
                               cs=None):
        """S iid prior draws for a node whose input is static within the
        I-step (layer 0): one K3 launch and one ancestral pass for all the
        ESS sweeps of an I-step."""
        sp = self.spec[l][k]
        if not sp.vecch:
            raise _not_ported("dense prior draws", "O1")
        p = params[l][k]
        Xn = self._node_input(l, k, latents)
        n = Xn.shape[0]
        ns = nn_state[l][k]
        pre = None
        if cs is not None and l == 0 and (l, k) in cs:
            st = cs[(l, k)]
            # prior draws carry no replicate diagonal: all-ones on valid lanes
            ones_g = torch.where(st['validT'], 1.0, 0.0).to(self.dtype)
            pre = (st['Xg_stat'], ones_g, st['validT'])
        w, sigma, idx_asc, _ = vcore.cond_weights(
            Xn[ns['ord']], ns['NN'], p['length'], p['nugget'], sp.name, pre=pre)
        eps = (torch.randn((S, n), generator=gen, dtype=self.dtype,
                           device=self.device)
               * torch.sqrt(p['scale']) * sigma[None, :])
        samp = vcore.ancestral_sample(eps, w, idx_asc)
        return samp[:, ns['rev']]

    def _ess_block_layer(self, l, latents, views, params, nn_state, gens,
                         pre_nu=None, s=None, plan=None):
        gen, host_gen = gens
        cols = []
        for k in range(len(self.spec[l])):
            if pre_nu is not None and (l, k) in pre_nu:
                cols.append(pre_nu[(l, k)][s])
            else:
                cols.append(self._draw_prior_node(l, k, latents, params,
                                                  nn_state, gen))
        nu = torch.stack(cols, dim=1)
        f = latents[l]

        def log_lik(fp):
            lat2 = latents[:l] + (fp,) + latents[l + 1:]
            return self._upper_loglik(l, lat2, params, nn_state)

        if plan is None:
            f_new = ess_update(host_gen, f, nu, log_lik,
                               spec=config.ess_spec(f.shape[0]))
            return latents[:l] + (f_new,) + latents[l + 1:], views

        # angle path: gathered block views are maintained across sweeps
        A_list = views[l]
        B_list = [nd_['B_all'][s] if nd_['B_all'] is not None
                  else self._gather_latent_view(nd_, nu) for nd_ in plan['nodes']]
        ll = self._plan_ll(plan, l, latents, nu, A_list, B_list)
        f_new, (c_a, s_a) = ess_update(host_gen, f, nu, log_lik,
                                       log_lik_angles=ll,
                                       spec=config.ess_spec(f.shape[0]),
                                       return_angle=True)
        new_A = tuple(c_a * A + s_a * B for A, B in zip(A_list, B_list))
        views = views[:l] + (new_A,) + views[l + 1:]
        return latents[:l] + (f_new,) + latents[l + 1:], views

    def _angle_applicable(self, l):
        """The angle evaluator (K2) applies when every upper GP node is
        Vecchia and carries no input-dependent ('ref') prior term."""
        return all(sp.vecch and sp.prior_name != 'ref' for sp in self.spec[l + 1])

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

    def _build_angle_plan(self, l, latents, params, nn_state, pre_nu, S, cs=None):
        """Per-I-step static views for layer l's angle evaluator (or None).

        ESS candidates are linear in (f, nu), so each upper node's gathered,
        length-scaled blocks decompose as cos*A + sin*B + C.  C (global dims
        + sentinels), the block diagonals and -- for final nodes -- the
        gathered targets are fixed for the I-step; the A views start here
        and are maintained across sweeps by the accepted-angle combine, and
        layer-0 nu views are gathered for all S sweeps at once."""
        if not (config.ess_spec(latents[l].shape[0]) > 1
                and self._angle_applicable(l)):
            return None
        dt = self.dtype
        n = latents[l].shape[0]
        nodes = []
        for j, sp in enumerate(self.spec[l + 1]):
            p = params[l + 1][j]
            ns = nn_state[l + 1][j]
            st = cs.get((l + 1, j)) if cs is not None else None
            dl = len(sp.input_dim)
            dg = len(sp.connect) if sp.connect is not None else 0
            length_full = torch.broadcast_to(p['length'], (dl + dg,))
            if st is not None:
                ordv, validT, safeT = st['ordv'], st['validT'], st['safeT']
            else:
                ordv = ns['ord']
                rev = torch.flip(ns['NN'], dims=(1,))
                validT = (rev >= 0).T
                safeT = torch.where(validT, rev.T, 0)
            m1 = safeT.shape[0]
            sent = cv.sentinels(n, m1, dt, self.device)
            nd_ = dict(name=sp.name, j=j, dl=dl, dg=dg, cols=list(sp.input_dim),
                       ordv=ordv, safeT=safeT, validT=validT,
                       s_lat=length_full[:dl], scale=p['scale'],
                       is_final=sp.is_final)
            C = torch.zeros((m1, dl, n), dtype=dt, device=self.device)
            if dg:
                if st is not None:
                    Cg = st['Xg_stat'] / length_full[dl:, None]
                else:
                    Gg = (self.X[:, list(sp.connect)][ordv] / length_full[dl:]).T
                    Cg = Gg[:, safeT].transpose(0, 1)
                C = torch.cat([C, Cg], dim=1)
            nd_['C'] = torch.where(validT[:, None, :], C, sent[:, None, :])
            ndiag_g = (st['nd_g'] if st is not None
                       else self._nd(j, sp, n)[ordv][safeT])
            nd_['diag'] = torch.where(
                validT, 1.0 + p['nugget'] * ndiag_g + vcore._f32_jitter(dt), 1.0)
            if sp.is_final:
                nd_['yg'] = (st['yg_stat'] if st is not None else
                             torch.where(validT, self.y_final[j][ordv][safeT], 0.0))
            else:
                nd_['yg'] = None
            nd_['B_all'] = None
            if pre_nu is not None and all((l, c) in pre_nu for c in nd_['cols']):
                # one batched gather for the A0 view and all S nu views
                nu_all = torch.stack([pre_nu[(l, c)] for c in nd_['cols']],
                                     dim=2)                    # (S, n, dl)
                lat0 = latents[l][:, nd_['cols']][None]        # (1, n, dl)
                allv = torch.cat([lat0, nu_all], dim=0)
                Ms = torch.movedim(allv / nd_['s_lat'], 1, 2)  # (S+1, dl, n)
                idx_comp = st['idx_comp'] if st is not None else ordv[safeT]
                G = torch.movedim(Ms[:, :, idx_comp], 2, 1)    # (S+1, m1, dl, n)
                G = torch.where(validT[None, :, None, :], G, 0.0)
                if dg:
                    G = torch.cat([G, G.new_zeros((S + 1, m1, dg, n))], dim=2)
                nd_['A0'] = G[0]
                nd_['B_all'] = G[1:]
            else:
                nd_['A0'] = self._gather_latent_view(nd_, latents[l])
            nodes.append(nd_)
        return dict(nodes=nodes)

    def _plan_ll(self, plan, l, latents, nu, A_list, B_list):
        """Angle evaluator from maintained views: (cos (K,), sin (K,)) ->
        (K,) float64 upper-layer log-liks of the candidates cos*f + sin*nu,
        one K2 launch per upper node."""
        def ll(cosv, sinv):
            cosv = torch.as_tensor(cosv, dtype=self.dtype, device=self.device)
            sinv = torch.as_tensor(sinv, dtype=self.dtype, device=self.device)
            total = torch.zeros(cosv.shape[0], dtype=torch.float64,
                                device=self.device)
            for nd_, A, B in zip(plan['nodes'], A_list, B_list):
                if nd_['yg'] is not None:
                    yg = nd_['yg']
                else:
                    y = latents[l + 1][:, nd_['j']]
                    yg = torch.where(nd_['validT'], y[nd_['ordv']][nd_['safeT']], 0.0)
                ld, q = cv.block_loglik_multi_t(A, B, nd_['C'], yg, nd_['diag'],
                                                cosv, sinv, name=nd_['name'],
                                                dl=nd_['dl'])
                total = total - 0.5 * (linalg.sum64(ld, dim=1)
                                       + linalg.sum64(q, dim=1)
                                       / nd_['scale'].to(torch.float64))
            return total

        return ll

    def _sweep(self, latents, views, params, nn_state, gens, pre_nu=None,
               s=None, plans=None):
        for l in range(self.n_layer - 1):
            plan = plans[l] if plans is not None else None
            latents, views = self._ess_block_layer(l, latents, views, params,
                                                   nn_state, gens, pre_nu, s, plan)
        return latents, views

    def _i_step(self, latents, params, nn_state, gens, burnin, cs=None):
        S = burnin + 1
        # layer-0 prior draws are iid across sweeps (their inputs are the
        # fixed global X), so draw them all at once
        pre_nu = {}
        if self.n_layer > 1:
            for k in range(len(self.spec[0])):
                pre_nu[(0, k)] = self._draw_prior_node_batch(
                    0, k, latents, params, nn_state, gens[0], S, cs)
        plans = tuple(self._build_angle_plan(l, latents, params, nn_state,
                                             pre_nu if l == 0 else None, S, cs)
                      for l in range(self.n_layer - 1))
        views = tuple(None if plan is None else tuple(nd_['A0'] for nd_ in plan['nodes'])
                      for plan in plans)
        for s in range(S):
            latents, views = self._sweep(latents, views, params, nn_state, gens,
                                         pre_nu, s, plans)
        return latents

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def sample(self, state, gen, host_gen, burnin=0):
        """(burnin+1) ESS-within-Gibbs sweeps over all hidden layers.
        ``gen`` draws the device-side normals; ``host_gen`` (a CPU
        generator) the ESS uniforms."""
        latents, params = state
        nn_state = self.get_nn_state()
        cs = self._chunk_static(nn_state)
        latents = self._i_step(latents, params, nn_state, (gen, host_gen),
                               burnin, cs)
        return latents, params

    def train_chunk(self, *args, **kwargs):
        raise _not_ported("SEM training (train_chunk, M-step)", "training")
