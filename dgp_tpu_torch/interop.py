"""Carry a DGP structure, or a trained gp, across from plain data (for
example from the JAX package's node attributes, which are numpy already, or
from a JSON file).

The input is a list of layers, each a list of per-node dicts of numpy
arrays, numbers and strings with the keys of `NODE_KEYS`; a missing key
leaves the node's default (so a dict of hyper-parameters alone gives a
node that `dgp` can initialise).  Priors come across as stored: the
coefficients are the node's adjusted ones (and, for 'ref', already
extended by the initialisation), so the constructor does not adjust them
again.  The training traces (``para_path``, ``R2``) come across too, so
that a model trained in one package can be estimated by, or continue
training in, the other.  The neighbour search (``nn_method``, and the IVF
centroids that warm-start its next build, ``_ivf_cache``) comes across
too, so a carried node searches the way it did.  A likelihood node comes
across by its ``type`` and ``name`` with the keys of `LIK_KEYS` (a
Categorical node's label encoder as its ``classes``).  `dgp_from_numpy`
carries a whole dgp (data, replicate wiring and layers) and `lgp_from_numpy`
a whole linked system, every imputation's containers, the same way.
"""
import numpy as np

from . import likelihoods, utils
from .models.node import kernel

#: node attributes carried across
NODE_KEYS = ('name', 'scale', 'length', 'nugget', 'nugget_est', 'scale_est',
             'prior_name', 'prior_coef', 'bds', 'cl', 'input_dim', 'connect',
             'input', 'global_input', 'output', 'W_diag', 'sum_residual', 'rep',
             'vecch', 'ord', 'NNarray', 'imp_NNarray', 'm', 'nn_method', '_ivf_cache',
             'para_path', 'R2')
#: likelihood-node attributes carried across (besides type and name)
LIK_KEYS = ('input_dim', 'input', 'output', 'rep', 'exact_post_idx', 'link',
            'num_classes', 'robustmax_eps')
_ARRAYS = ('input', 'global_input', 'output', 'para_path', 'R2', 'W_diag',
           'sum_residual', 'cl')


def _lik_from_numpy(d):
    """One likelihood node from a dict of its attributes."""
    cls = getattr(likelihoods, d['name'])
    if d['name'] == 'Categorical':
        node = cls(num_classes=d.get('num_classes'), link=d.get('link'),
                   robustmax_eps=d.get('robustmax_eps', 1e-3))
        if d.get('classes') is not None:
            node.class_encoder = utils.LabelEncoder()
            node.class_encoder.classes_ = np.asarray(d['classes'])
    else:
        node = cls()
    for key in ('input_dim', 'input', 'output', 'exact_post_idx'):
        if d.get(key) is not None:
            setattr(node, key, np.asarray(d[key]))
    if d.get('rep') is not None:
        node.rep = np.asarray(d['rep'], np.int64)
    return node


def node_from_numpy(d):
    """One node from a dict of its attributes: a `kernel`, or a likelihood
    node when ``d['type']`` says so."""
    if d.get('type') == 'likelihood':
        return _lik_from_numpy(d)
    node = kernel(length=np.asarray(d['length']), scale=d.get('scale', 1.0),
                  nugget=d.get('nugget', 1e-6), name=d.get('name', 'sexp'),
                  prior_name=d.get('prior_name', 'ga'), bds=d.get('bds'),
                  nugget_est=bool(d.get('nugget_est', False)),
                  scale_est=bool(d.get('scale_est', False)),
                  input_dim=d.get('input_dim'), connect=d.get('connect'))
    dt = node.length.dtype
    if d.get('prior_coef') is not None:
        node.prior_coef = np.array(d['prior_coef'], dt)
    for key in _ARRAYS:
        if d.get(key) is not None:
            setattr(node, key, np.asarray(d[key], dt))
    if d.get('rep') is not None:
        node.rep = np.asarray(d['rep'], np.int64)
    if d.get('vecch') is not None:
        node.vecch = bool(d['vecch'])
    if d.get('ord') is not None:
        node.ord = np.asarray(d['ord'], np.int64)
        node.rev_ord = np.argsort(node.ord)
        node.NNarray = np.asarray(d['NNarray'], np.int64)
        node.vecch = True
    if d.get('imp_NNarray') is not None:
        node.imp_NNarray = np.asarray(d['imp_NNarray'], np.int64)
    if d.get('m') is not None:
        node.m = int(d['m'])
    if d.get('nn_method') is not None:
        node.nn_method = str(d['nn_method'])
    if d.get('_ivf_cache') is not None:
        node._ivf_cache = {k: np.array(v) for k, v in d['_ivf_cache'].items()}
    if node.input is not None:
        node.D = node.input.shape[1] + (0 if node.connect is None else len(node.connect))
    if node.para_path is None:
        node.para_path = np.atleast_2d(np.concatenate((node.scale, node.length,
                                                       node.nugget)))
    return node


def node_to_numpy(node):
    """The dict of a node of either package: the `NODE_KEYS` attributes of a
    GP node, or type, name and the `LIK_KEYS` of a likelihood node."""
    if node.type == 'likelihood':
        d = {k: getattr(node, k, None) for k in LIK_KEYS}
        enc = getattr(node, 'class_encoder', None)
        d.update(type='likelihood', name=node.name,
                 classes=None if enc is None else np.asarray(enc.classes_))
        return d
    return {k: getattr(node, k, None) for k in NODE_KEYS}


def layers_from_numpy(spec):
    """The port's ``all_layer`` (list of layers of nodes) from a list of
    layers of per-node dicts."""
    return [[node_from_numpy(d) for d in layer] for layer in spec]


def layers_to_numpy(all_layer):
    """The inverse of `layers_from_numpy` for any structure whose nodes
    carry the `NODE_KEYS` attributes (either package's)."""
    return [[node_to_numpy(node) for node in layer] for layer in all_layer]


def gp_from_numpy(model, device=None):
    """A port `gp` carrying the state of a gp of either package: its
    (replicate-collapsed) data and its node with the trained
    hyper-parameters, prior and, under Vecchia, ordering and neighbours.
    The node is not re-initialised; a dense node's prediction statistics
    are recomputed on ``device`` (default: the card)."""
    from . import config
    from .models.gp import gp

    self = gp.__new__(gp)
    self.device = config.resolve_device(device)
    self.check_rep = model.check_rep
    dt = config.np_dtype()
    self.X, self.Y = np.asarray(model.X, dt), np.asarray(model.Y, dt)
    self.indices = model.indices
    if self.indices is not None:
        self.W_diag = np.asarray(model.W_diag, dt)
        self.sum_residual = np.asarray(model.sum_residual, dt)
    self.n_data = self.X.shape[0]
    self.vecch = bool(model.vecch)
    self.m = int(model.m)
    self.ord_fun = model.ord_fun
    self.kernel = node_from_numpy(node_to_numpy(model.kernel))
    self.kernel.device = self.device
    self.kernel.vecch = self.vecch
    self.kernel.target = 'gp'
    if not self.vecch:
        self.kernel.compute_stats()
    return self


def dgp_from_numpy(model, device=None):
    """A port `dgp` carrying the state of a dgp of either package without
    drawing anything: its data and replicate wiring, its settings
    (``n_data, m, vecch, ord_fun, nn_method, block, N, burnin``) and its
    layers as `node_to_numpy` gives them (latents, orderings, neighbours,
    hyper-parameter traces), each GP node on ``device`` (default: the
    card), with an imputer there that has not sampled."""
    from . import config
    from .models.dgp import dgp
    from .models.imputation import imputer

    self = dgp.__new__(dgp)
    self.device = config.resolve_device(device)
    dt = config.np_dtype()
    self.X = np.asarray(model.X, dt)
    Y = np.asarray(model.Y)
    self.Y = Y if np.issubdtype(Y.dtype, np.integer) else np.asarray(Y, dt)
    self.indices = None if model.indices is None else np.asarray(model.indices)
    self.counts = None if model.counts is None else np.asarray(model.counts)
    self.check_rep = model.check_rep
    self.n_data, self.m, self.vecch = int(model.n_data), int(model.m), bool(model.vecch)
    self.ord_fun, self.nn_method = model.ord_fun, model.nn_method
    self.block, self.N, self.burnin = model.block, int(model.N), model.burnin
    self.all_layer = layers_from_numpy(layers_to_numpy(model.all_layer))
    self.n_layer = len(self.all_layer)
    for layer in self.all_layer:
        for node in layer:
            if node.type == 'gp':
                node.device = self.device
                node.ord_fun = model.ord_fun
    self.imp = imputer(self.all_layer, self.block, self.device)
    return self


def lgp_from_numpy(system, device=None):
    """A port `lgp` carrying a linked system of either package without
    drawing anything: the template containers and every imputation's, each
    with its wiring (``local_input_idx``) and its nodes as `node_to_numpy`
    gives them (imputed inputs and outputs, global inputs, ordering and
    neighbours, hyper-parameters).  The nodes compute on ``device``
    (default: the card); a DGP container gets an imputer that has drawn
    nothing (its imputations are the carried ones)."""
    import copy

    from . import config
    from .models.imputation import imputer
    from .models.linkgp import container, lgp

    dev = config.resolve_device(device)

    def carry(cont):
        new = container.__new__(container)
        new.type, new.vecch, new.device = cont.type, bool(cont.vecch), dev
        new.local_input_idx = copy.deepcopy(cont.local_input_idx)
        if cont.type == 'gp':
            new.structure = node_from_numpy(node_to_numpy(cont.structure))
            nodes = [new.structure]
        else:
            new.structure = layers_from_numpy(layers_to_numpy(cont.structure))
            nodes = [nd for layer in new.structure for nd in layer if nd.type == 'gp']
            new.imp = imputer(new.structure, True, dev)
        for nd in nodes:
            nd.device = dev
        return new

    self = lgp.__new__(lgp)
    self.device = dev
    self.L = system.L
    self.num_model = list(system.num_model)
    self.all_layer = [[carry(c) for c in layer] for layer in system.all_layer]
    self.all_layer_set = [[[carry(c) for c in layer] for layer in one]
                          for one in system.all_layer_set]
    return self
