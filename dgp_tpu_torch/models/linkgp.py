"""Linked (D)GP emulation of feed-forward systems of computer models; the
counterpart of `dgp_tpu/models/linkgp.py`.

API mirror of reference `dgpsi/linkgp.py`: `container` wraps a trained GP
(`gp.export()`) or DGP (`dgp.estimate()`) with its input wiring; `lgp` stores
a layered system of containers with N imputations of every DGP container and
propagates means and variances (or samples) through it.  A DGP container's
imputations are drawn on its device, by the ESS engine whose Vecchia sweeps
run K3 and K2 (models/compiled.py).  A GP container has no imputations, so
the imputations share one copy of it.  ``predict`` loops over the
imputations and, within one, over the system's containers, and predicts a
shared first-layer container once a call; every node's prediction
computes on lgp's device.  The JAX package also has a device pass over all
imputations at once (`dgp_tpu/models/linked_ensemble.py`, one jitted
program per query chunk); in eager PyTorch that pass measured no faster
than this loop on the card, so it is not ported (PERF.md, PR 7).
A 'mean_var' prediction takes the test rows in chunks of
`ensemble._CHUNK`; each GP node's training-side operands go to the device
once and stay there from request to request, remade only for a node
attribute replaced since (`kernel.prediction_operands`); ``predict(sharded=True)``
and `ppredict` split the chunks over the devices of lgp's mesh
(`parallel/mesh.py`): each share's chunks go through the same loop on
copies of the system whose nodes compute on the share's device, one host
thread per share, with the same results bit for bit.  'sampling' draws from numpy's global generator node
by node, so it is neither chunked nor split.
A `predict` call is the root span ``lgp.predict``, each imputation's pass a
``predict.imputation`` span and each container's prediction in it a
``predict.container`` span (`tracing`).
"""
import contextlib
import copy

import numpy as np

from .. import config, tracing
from ..parallel import mesh as pmesh
from ..utils import have_same_shape
from . import ensemble
from .imputation import imputer


def _gp_nodes(structure):
    """The GP nodes of a container's structure (a node, or layers of them)."""
    if not isinstance(structure, list):
        return [structure]
    return [node for layer in structure for node in layer if node.type == 'gp']


def _on_device(cont, device):
    """A copy of container ``cont`` whose GP nodes (copies sharing their
    arrays) compute on ``device``."""
    def node_on(node):
        node = copy.copy(node)
        if node.type == 'gp':
            node.device = device
        return node
    c = copy.copy(cont)
    c.device = device
    c.structure = (node_on(c.structure) if c.type == 'gp' else
                   [[node_on(node) for node in layer] for layer in c.structure])
    return c


def _cat_rows(parts):
    """The shares' nested lists or tuples of (rows, ...) arrays joined row
    by row."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=0)
    return type(parts[0])(_cat_rows([p[i] for p in parts]) for i in range(len(parts[0])))


class container:
    """Container of a trained (D)GP emulator for linked emulation
    (linkgp.py:12).  Its nodes compute on ``device`` (default: the card); a
    DGP's imputer draws there, 50 burn-in sweeps at construction."""

    def __init__(self, structure, local_input_idx=None, block=True, device=None):
        self.device = config.resolve_device(device)
        if len(structure) == 1:
            self.type = 'gp'
            self.structure = structure[0]
            self.vecch = bool(self.structure.vecch)
        else:
            self.type = 'dgp'
            self.structure = structure
            self.vecch = bool(self.structure[0][0].vecch)
        for node in _gp_nodes(self.structure):
            node.device = self.device
        if self.type == 'dgp':
            self.imp = imputer(self.structure, block, self.device)
            if self.vecch:
                self.imp.update_ord_nn()
            self.imp.sample(burnin=50)
        self.local_input_idx = local_input_idx

    def to_vecchia(self):
        if not self.vecch:
            self.vecch = True
            for node in _gp_nodes(self.structure):
                node.vecch = True
            if self.type == 'dgp':
                self.imp.invalidate()      # its engine was built for the dense nodes

    def remove_vecchia(self):
        if self.vecch:
            self.vecch = False
            for node in _gp_nodes(self.structure):
                node.vecch = False
            if self.type == 'gp':
                self.structure.compute_stats()
            else:
                self.imp.invalidate()

    def set_local_input(self, idx, new=False):
        """Set (or, with ``new``, return a copy with) the input wiring
        (linkgp.py:91)."""
        if new:
            cp = copy.copy(self)
            cp.local_input_idx = idx
            return cp
        self.local_input_idx = idx

    def __copy__(self):
        new_inst = type(self).__new__(self.__class__)
        new_inst.type = self.type
        new_inst.structure = self.structure
        new_inst.vecch = self.vecch
        new_inst.device = self.device
        if self.type == 'dgp':
            new_inst.imp = self.imp
        new_inst.local_input_idx = copy.copy(self.local_input_idx)
        return new_inst


class lgp:
    """A system of (D)GP emulators for linked prediction (linkgp.py:127):
    ``all_layer`` is a list of layers of containers, and every DGP container
    gets N imputations (one more ESS sweep each, on its device).  Each
    imputation's copy of the system computes on ``device`` (default: the
    card)."""

    def __init__(self, all_layer, N=10, device=None):
        self.device = config.resolve_device(device)
        self.L = len(all_layer)
        self.all_layer = all_layer
        self.num_model = [len(all_layer[l]) for l in range(1, self.L)]
        if not any(cont.type == 'dgp' for layer in all_layer for cont in layer):
            N = 1
        self.all_layer_set = []
        gp_copies = {}
        for _ in range(N):
            one_imputation = []
            for l in range(self.L):
                layer = []
                for cont in self.all_layer[l]:
                    if cont.type == 'dgp':
                        if cont.vecch:
                            cont.imp.update_ord_nn()
                        cont.imp.sample()
                        if not cont.vecch:
                            cont.imp.key_stats()
                        one = copy.deepcopy(cont)
                    elif id(cont) in gp_copies:     # no imputations: one copy for all
                        one = gp_copies[id(cont)]
                    else:
                        one = gp_copies[id(cont)] = copy.deepcopy(cont)
                    one.device = self.device
                    for node in _gp_nodes(one.structure):
                        node.device = self.device
                    layer.append(one)
                one_imputation.append(layer)
            self.all_layer_set.append(one_imputation)

    def set_vecchia(self, mode):
        """Switch every container (``mode`` a bool) or each one (a list of
        lists of bools shaped as the system) to or from Vecchia
        (linkgp.py:180)."""
        if isinstance(mode, list):
            if not have_same_shape(self.all_layer, mode):
                raise Exception('mode has a different shape as all_layer.')
        else:
            mode = [[mode for _ in layer] for layer in self.all_layer]
        for layers in [self.all_layer] + self.all_layer_set:
            for layer, mode_layer in zip(layers, mode):
                for cont, cont_mode in zip(layer, mode_layer):
                    if cont_mode:
                        cont.to_vecchia()
                    else:
                        cont.remove_vecchia()
                        if cont.type == 'dgp' and layers is not self.all_layer:
                            cont.imp.key_stats()

    # ------------------------------------------------------------------
    def predict(self, x, method='mean_var', full_layer=False, sample_size=50, m=50,
                sharded=False):
        """Propagate predictions through the emulator system (linkgp.py:285):
        x is the first layer's global input (M, d), or a list with one entry
        per layer (the first layer's input, then for each later layer a list
        of its containers' external inputs or None).  'mean_var' gives the
        mean and variance of the final layer's outputs (with ``full_layer``,
        of every layer's), mixed over the imputations; 'sampling' gives
        ``sample_size`` draws per imputation.  ``sharded`` splits the row
        chunks of a 'mean_var' prediction over the devices of lgp's mesh
        (`parallel.mesh.model_mesh`)."""
        with tracing.span('lgp.predict'):
            if isinstance(x, list) and len(x) != self.L:
                raise Exception('When the test input is a list it must have global '
                                'inputs for all layers (use None for layers without).')
            if not isinstance(x, list):
                if x.ndim == 1:
                    raise Exception('The testing input has to be a numpy 2d-array.')
                x = [x] + [[None] * num for num in self.num_model]
            if method == 'mean_var':
                sample_size = 1
            dt = config.np_dtype()
            mean_pred, variance_pred, sample_pred = [], [], []
            if method == 'mean_var':
                results = self._predict_rows(x, full_layer, m, dt, sharded)
            else:
                first = {}
                results = [self._predict_one(one_imputed, x, method, full_layer, sample_size,
                                             m, dt, first) for one_imputed in self.all_layer_set]
            for res in results:
                if method == 'mean_var':
                    mean_pred.append(res[0])
                    variance_pred.append(res[1])
                else:
                    sample_pred.append(res)
            if method == 'mean_var':
                if full_layer:
                    mu = [[np.mean(i, axis=0) for i in zip(*case_m)]
                          for case_m in zip(*mean_pred)]
                    sigma2 = [[np.mean(np.square(i) + j, axis=0) - np.mean(i, axis=0) ** 2
                               for i, j in zip(zip(*cm), zip(*cv))]
                              for cm, cv in zip(zip(*mean_pred), zip(*variance_pred))]
                else:
                    mu = [np.mean(i, axis=0) for i in zip(*mean_pred)]
                    sigma2 = [np.mean(np.square(i) + j, axis=0) - np.mean(i, axis=0) ** 2
                              for i, j in zip(zip(*mean_pred), zip(*variance_pred))]
                return mu, sigma2
            if full_layer:
                return [[np.concatenate(i, axis=2) for i in zip(*case_s)]
                        for case_s in zip(*sample_pred)]
            return [np.concatenate(i, axis=2) for i in zip(*sample_pred)]

    def _predict_rows(self, x, full_layer, m, dt, sharded):
        """The 'mean_var' results of `_predict_one` for every imputation,
        chunk of rows by chunk; with ``sharded`` the chunks split over
        lgp's mesh, each share on copies of the imputations whose GP nodes
        compute on its device, on its own host thread.  Each GP node's
        training-side operands stay on the device between calls
        (`kernel.prediction_operands`); the shares' copies make their own
        for the call."""
        def gp_nodes(systems):
            nodes = {id(node): node for one in systems for layer in one for cont in layer
                     for node in _gp_nodes(cont.structure)}
            return nodes.values()

        for node in gp_nodes(self.all_layer_set):
            if not node.vecch and node.Rinv is None:
                node.compute_stats()

        def rows(systems, sl):
            parts = []
            with contextlib.ExitStack() as stack:
                for node in gp_nodes(systems):
                    stack.enter_context(node.prediction_operands())
                for c in pmesh.chunks(sl, ensemble._CHUNK):
                    xs = [np.asarray(x[0])[c]] + [[None if e is None else np.asarray(e)[c]
                                                   for e in layer] for layer in x[1:]]
                    first = {}
                    parts.append([self._predict_one(one, xs, 'mean_var', full_layer, 1, m,
                                                    dt, first) for one in systems])
            return [_cat_rows([p[i] for p in parts]) for i in range(len(systems))]

        n = len(x[0])
        if not sharded:
            return rows(self.all_layer_set, slice(0, n))

        def share(dev, sl):
            copies = {}     # a container shared by the imputations stays shared

            def on(c):
                if id(c) not in copies:
                    copies[id(c)] = _on_device(c, dev)
                return copies[id(c)]
            return rows([[[on(c) for c in layer] for layer in one]
                         for one in self.all_layer_set], sl)
        parts = pmesh.map_shares(pmesh.model_mesh(self.device), n, share, ensemble._CHUNK)
        return [_cat_rows([p[i] for p in parts]) for i in range(len(self.all_layer_set))]

    def _predict_one(self, one_imputed, x, method, full_layer, sample_size, m, dt, first):
        """One imputation's pass through the system, container by container.
        A first-layer container's prediction depends on ``x`` alone, so
        ``first`` (id of the container -> its mean and variance), shared
        by the imputations of one call, predicts a container that they
        share (every GP container) once."""
        with tracing.span('predict.imputation'):
            mean_layers, var_layers, sample_layers = [], [], []
            m_l_next, v_l_next = [], []
            m_last, v_last, sample_last = [], [], []
            for l in range(self.L):
                layer = one_imputed[l]
                m_l, v_l, sample_l = [], [], []
                for k, model in enumerate(layer):
                    with tracing.span('predict.container', kind=model.type, layer=l):
                        if l == 0:
                            if isinstance(model.local_input_idx, list):
                                raise Exception('First-layer local_input_idx must be a 1d-array.')
                            input_lk = np.asarray(x[0], dt)[:, model.local_input_idx]
                            if id(model) in first:
                                m_lk, v_lk = first[id(model)]
                            elif model.type == 'gp':
                                m_lk, v_lk = first[id(model)] = self.gp_pred(
                                    input_lk, None, None, None, model.structure, m)
                            else:
                                _, _, m_lk, v_lk = self.dgp_pred(input_lk, None, None, None,
                                                                 model.structure, m)
                            m_l.append(m_lk)
                            v_l.append(v_lk)
                            if method == 'sampling' and full_layer:
                                sample_l.append(self._normal_samples(m_lk, v_lk, sample_size))
                        else:
                            local_input_idx = self._norm_idx(model.local_input_idx, l)
                            external = x[l][k]
                            if external is not None:
                                external = np.asarray(external, dt)
                            m_in, v_in = [], []
                            for i in range(l):
                                idx = local_input_idx[i]
                                if idx is not None:
                                    m_in.append(m_l_next[i][:, idx])
                                    v_in.append(v_l_next[i][:, idx])
                            m_in = np.concatenate(m_in, axis=1)
                            v_in = np.concatenate(v_in, axis=1)
                            if model.type == 'gp':
                                m_lk, v_lk = self.gp_pred(None, m_in, v_in, external,
                                                          model.structure, m)
                                if method == 'sampling' and l == self.L - 1:
                                    sample_lk = self._normal_samples(m_lk, v_lk, sample_size)
                            else:
                                m_before, v_before, m_lk, v_lk = self.dgp_pred(
                                    None, m_in, v_in, external, model.structure, m)
                                if method == 'sampling' and l == self.L - 1:
                                    sample_lk = self._dgp_samples(model, m_lk, m_before,
                                                                  v_before, sample_size)
                            if l == self.L - 1:
                                m_last.append(m_lk)
                                v_last.append(v_lk)
                                if method == 'sampling':
                                    sample_last.append(sample_lk)
                            else:
                                m_l.append(m_lk)
                                v_l.append(v_lk)
                                if method == 'sampling' and full_layer:
                                    sample_l.append(self._normal_samples(m_lk, v_lk, sample_size))
                if l < self.L - 1:
                    m_l_next.append(np.concatenate(m_l, axis=1))
                    v_l_next.append(np.concatenate(v_l, axis=1))
                    mean_layers.append(m_l)
                    var_layers.append(v_l)
                    sample_layers.append(sample_l)
            if method == 'mean_var':
                if full_layer:
                    return mean_layers + [m_last], var_layers + [v_last]
                return m_last, v_last
            if full_layer:
                return sample_layers + [sample_last]
            return sample_last

    @staticmethod
    def _norm_idx(local_input_idx, l):
        if isinstance(local_input_idx, list):
            if len(local_input_idx) != l:
                raise Exception(f'local_input_idx should be a list of length {l}.')
            return local_input_idx
        out = [None] * (l - 1)
        out.append(local_input_idx)
        return out

    @staticmethod
    def _normal_samples(m_lk, v_lk, sample_size):
        r, c = np.shape(m_lk)
        s = np.random.normal(m_lk, np.sqrt(v_lk), size=(sample_size, r, c))
        return s.transpose(2, 1, 0)

    @staticmethod
    def _dgp_samples(model, m_lk, m_before, v_before, sample_size):
        r, c = np.shape(m_lk)
        out = np.empty((c, r, sample_size))
        for count, node in enumerate(model.structure[-1]):
            if node.type == 'gp':
                out[count] = np.random.normal(m_lk[:, [count]],
                                              np.sqrt(v_before[:, [count]]),
                                              size=(r, sample_size))
            else:
                dgp_sample = np.random.normal(
                    m_before, np.sqrt(v_before),
                    size=(sample_size, m_before.shape[0], m_before.shape[1]))
                out[count] = np.array([
                    node.sampling(dgp_sample[i][:, node.input_dim])
                    for i in range(sample_size)]).T
        return out

    def ppredict(self, x, method='mean_var', full_layer=False, sample_size=50, m=50,
                 chunk_num=None, core_num=None):
        """`predict` with ``sharded=True`` (``chunk_num`` and ``core_num``
        of the reference's process pool are ignored)."""
        return self.predict(x, method=method, full_layer=full_layer,
                            sample_size=sample_size, m=m, sharded=True)

    # ------------------------------------------------------------------
    @staticmethod
    def gp_pred(x, m, v, z, structure, m_pred):
        """One GP emulator's prediction under deterministic (x) or Gaussian
        (m, v) inputs (linkgp.py:503)."""
        structure.pred_m = m_pred
        if x is None:
            mu, s2 = structure.linkgp_prediction(m=m, v=v, z=z)
        else:
            mu, s2 = structure.gp_prediction(x=x, z=z)
        return np.asarray(mu).reshape(-1, 1), np.asarray(s2).reshape(-1, 1)

    @staticmethod
    def dgp_pred(x, m, v, z, structure, pred_m):
        """One DGP emulator's layerwise prediction under deterministic or
        Gaussian inputs (linkgp.py:517)."""
        M = len(m) if x is None else len(x)
        L = len(structure)
        internal_idx = structure[0][0].input_dim
        external_idx = structure[0][0].connect
        in_mean = in_var = None
        lik_mean = lik_var = None
        for l in range(L):
            layer = structure[l]
            out_mean = np.empty((M, len(layer)))
            out_var = np.empty((M, len(layer)))
            for k, node in enumerate(layer):
                if l == 0:
                    node.pred_m = pred_m
                    if x is None:
                        mk, vk = node.linkgp_prediction(m=m, v=v, z=z)
                    else:
                        mk, vk = node.gp_prediction(x=x, z=z)
                elif node.type == 'likelihood':
                    mk, vk = node.prediction(m=in_mean[:, node.input_dim],
                                             v=in_var[:, node.input_dim])
                else:
                    node.pred_m = pred_m
                    m_in = in_mean[:, node.input_dim]
                    v_in = in_var[:, node.input_dim]
                    if node.connect is None:
                        mk, vk = node.linkgp_prediction(m=m_in, v=v_in, z=None)
                    elif x is not None:
                        mk, vk = node.linkgp_prediction(m=m_in, v=v_in,
                                                        z=x[:, node.connect])
                    else:
                        # connected global dims may themselves be stochastic
                        if l == L - 1:
                            idx1 = np.where(node.connect[:, None] == internal_idx[None, :])[1]
                            if external_idx is None:
                                idx2 = np.array([], int)
                            else:
                                idx2 = np.where(node.connect[:, None]
                                                == external_idx[None, :])[1]
                        else:
                            D = np.shape(m)[1]
                            idx1 = node.connect[node.connect <= (D - 1)]
                            idx2 = node.connect[node.connect > (D - 1)] - D
                        if idx1.size == 0:
                            mk, vk = node.linkgp_prediction(m=m_in, v=v_in, z=z[:, idx2])
                        elif idx2.size == 0:
                            mk, vk = node.linkgp_prediction_full(
                                m=m_in, v=v_in, m_z=m[:, idx1], v_z=v[:, idx1], z=None)
                        else:
                            mk, vk = node.linkgp_prediction_full(
                                m=m_in, v=v_in, m_z=m[:, idx1], v_z=v[:, idx1],
                                z=z[:, idx2])
                out_mean[:, k], out_var[:, k] = mk, vk
            if l == L - 1:
                lik_mean, lik_var = out_mean, out_var
            else:
                in_mean, in_var = out_mean, out_var
        return in_mean, in_var, lik_mean, lik_var
