"""Import dgpsi-saved checkpoints into dgp_tpu_torch objects; the port's
own copy of `dgp_tpu/io_dgpsi.py`, whose converters build the port's
classes with every part on the device `read_dgpsi` is given.

The reference persists whole object graphs with dill (`dgpsi/utils.py:18-42`)
-- `write(emu, path)` dumps the live `gp` / `dgp` / `emulator` / `lgp`
object, including every `kernel` node with its trained hyper-parameters,
imputed latents (`input`/`output` arrays) and cached statistics.

`read_dgpsi(path)` loads such a file WITHOUT requiring the dgpsi package:
any class under the ``dgpsi.*`` namespace is materialised as a plain
attribute stub during unpickling, and the stub graph is then mapped onto
the equivalent dgp_tpu_torch object.  Trained hyper-parameters, latent layers,
replicate wiring, prior state and hyper-parameter traces are carried over
verbatim; device-side caches (Cholesky stats, Vecchia orderings) are
recomputed on the device, since they are deterministic functions of the
carried state.

What is imported faithfully vs. redrawn:

* ``kernel`` / ``gp`` / ``dgp``: exact state transfer (latents included).
* ``emulator``: the N stored imputations are transferred verbatim; only
  the per-node prediction caches are recomputed.
* ``container`` / ``lgp``: containers transfer exactly; an lgp's stored
  per-imputation container sets transfer verbatim as well.

Migration shims on the reference side (`kernel_class.__setstate__`,
kernel_class.py:146-205) renormalise pre-2.4 pickles at *load* time; this
reader applies the same defaults for absent attributes and -- for stub
loads, where the reference's ``__setstate__`` never runs -- the same
pre-2.4 ``gfod`` prior-coefficient renormalisation.
"""
import pickle

import numpy as np

from . import config


# ----------------------------------------------------------------------
# stub unpickling
# ----------------------------------------------------------------------
class _Stub:
    """Attribute bag standing in for a dgpsi class during unpickle."""
    _dgpsi_name = None

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<dgpsi-stub {self._dgpsi_name}>"


_STUB_CACHE = {}


def _stub_class(module, name):
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"_dgpsi_name": name,
                                                 "_dgpsi_module": module})
    return _STUB_CACHE[key]


class _DgpsiUnpickler(pickle.Unpickler):
    """Resolves ``dgpsi.*`` class references to stubs when the dgpsi
    package is not importable.

    Two stream styles exist: plain-pickle / ``dill(byref=True)`` saves
    reference classes by name (handled by the stub), while dgpsi's own
    ``write`` (dill, byref=False) saves classes BY VALUE -- the stream
    then reconstructs them through ``dill._dill``, which imports the
    ``dgpsi.*`` modules for the method globals.  By-value streams
    therefore need dgpsi importable (the normal migration scenario: the
    user saving the checkpoint has dgpsi installed)."""

    def find_class(self, module, name):
        if module == "dgpsi" or module.startswith("dgpsi."):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return _stub_class(module, name)
        if module.startswith("dill."):
            import dill  # noqa: F401  (baked-in; resolves _dill helpers)
        return super().find_class(module, name)


def _load_stub_graph(pkl_file):
    path = pkl_file if pkl_file.endswith(".pkl") else pkl_file + ".pkl"
    with open(path, "rb") as f:
        try:
            return _DgpsiUnpickler(f).load()
        except ModuleNotFoundError as e:  # by-value stream, dgpsi absent
            raise ImportError(
                "this dgpsi checkpoint stores its classes by value (dill "
                "default); loading it requires the dgpsi package (or the "
                "reference source tree) to be importable") from e


def _clsname(obj):
    """dgpsi class name of a loaded node -- stub or real instance."""
    if isinstance(obj, _Stub):
        return obj._dgpsi_name
    t = type(obj)
    if t.__module__ == "dgpsi" or t.__module__.startswith("dgpsi."):
        return t.__name__
    return None


# ----------------------------------------------------------------------
# converters
# ----------------------------------------------------------------------
def _arr(x, dt=None):
    if x is None:
        return None
    a = np.asarray(x)
    if dt is not None and np.issubdtype(a.dtype, np.floating):
        a = np.asarray(a, dt)
    return a.copy()


def _conv_kernel(s, dev):
    """dgpsi kernel node -> dgp_tpu_torch kernel node on ``dev`` (exact
    state transfer).

    The saved node carries FINAL prior_coef values (the reference applies
    its ga/inv_ga shift and the 'ref' b-append at init time,
    kernel_class.py:92-110 and gp.py:103-110), so they copy verbatim.
    """
    from .models.node import kernel as Ker
    dt = config.np_dtype()
    k = Ker.__new__(Ker)
    k.type = 'gp'
    k.device = dev
    k.length = np.atleast_1d(_arr(s.length, dt))
    k.scale = np.atleast_1d(_arr(s.scale, dt))
    k.nugget = np.atleast_1d(_arr(s.nugget, dt))
    k.name = s.name
    k.prior_name = getattr(s, 'prior_name', 'ga')
    k.prior_coef = _arr(getattr(s, 'prior_coef', None), dt)
    # pre-2.4 pickles carry a compiled-prior attribute ('gfod') and store
    # prior_coef in the OLD parameterisation; the reference renormalises at
    # load time (kernel_class.__setstate__, kernel_class.py:146-158).  When
    # dgpsi itself is importable its __setstate__ already ran; stub loads
    # (dgpsi absent) see the raw pre-2.4 state and migrate here.
    if isinstance(s, _Stub) and hasattr(s, 'gfod') and k.prior_coef is not None:
        if k.prior_name == 'ga':
            k.prior_coef[0] -= 1
        elif k.prior_name == 'inv_ga':
            k.prior_coef[0] += 1
    if k.prior_name == 'ref':
        k.cl = _arr(getattr(s, 'cl', None), dt)
    k.nugget_est = bool(getattr(s, 'nugget_est', False))
    k.scale_est = bool(getattr(s, 'scale_est', False))
    k.input_dim = _arr(getattr(s, 'input_dim', None))
    k.connect = _arr(getattr(s, 'connect', None))
    k.para_path = _arr(getattr(s, 'para_path', None), dt)
    k.global_input = _arr(getattr(s, 'global_input', None), dt)
    k.input = _arr(getattr(s, 'input', None), dt)
    k.output = _arr(getattr(s, 'output', None), dt)
    k.rep = _arr(getattr(s, 'rep', None))
    k.rep_hetero = _arr(getattr(s, 'rep_hetero', None))
    # deterministic caches: recomputed on demand
    k.Rinv = None
    k.Rinv_y = None
    k.vecch = bool(getattr(s, 'vecch', False) or False)
    k.D = int(s.D) if getattr(s, 'D', None) is not None else (
        k.input.shape[1] + (0 if k.connect is None else len(k.connect))
        if k.input is not None else None)
    k.ord = None
    k.rev_ord = None
    k.m = int(s.m) if getattr(s, 'm', None) is not None else 25
    k.pred_m = getattr(s, 'pred_m', None)
    k.NNarray = None
    k.imp_NNarray = None
    k.nn_method = getattr(s, 'nn_method', 'exact')
    k.ord_fun = None
    k.iter_count = int(getattr(s, 'iter_count', 0) or 0)
    k.target = getattr(s, 'target', 'dgp')
    k.bds = _arr(getattr(s, 'bds', None), dt)
    k.R2 = _arr(getattr(s, 'R2', None), dt)
    k.loo_state = bool(getattr(s, 'loo_state', False))
    k.sum_residual = _arr(getattr(s, 'sum_residual', None), dt)
    k.W_diag = _arr(getattr(s, 'W_diag', None), dt)
    return k


_LIK_NAMES = ('Poisson', 'Hetero', 'NegBin', 'Categorical', 'ZIP', 'ZINB')


def _conv_likelihood(s):
    from . import likelihoods as L
    name = _clsname(s)
    cls = getattr(L, name)
    if name == 'Categorical':
        o = cls(num_classes=getattr(s, 'num_classes', None),
                input_dim=_arr(getattr(s, 'input_dim', None)),
                link=getattr(s, 'link', None))
        o.class_encoder = getattr(s, 'class_encoder', None)
    else:
        o = cls(input_dim=_arr(getattr(s, 'input_dim', None)))
    dt = config.np_dtype()
    o.input = _arr(getattr(s, 'input', None), dt)
    o.output = _arr(getattr(s, 'output', None))
    o.rep = _arr(getattr(s, 'rep', None))
    if getattr(s, 'exact_post_idx', None) is not None:
        o.exact_post_idx = list(s.exact_post_idx)
    return o


def _conv_node(s, dev):
    name = _clsname(s)
    if name == 'kernel':
        return _conv_kernel(s, dev)
    if name in _LIK_NAMES:
        return _conv_likelihood(s)
    raise ValueError(f"unsupported dgpsi node class: {name}")


def _conv_layers(layers, dev):
    return [[_conv_node(n, dev) for n in layer] for layer in layers]


def _refresh_stats(all_layer):
    """Recompute deterministic prediction caches from the carried state."""
    for layer in all_layer:
        for node in layer:
            if node.type == 'gp':
                if node.vecch:
                    node.ord_nn()
                else:
                    node.compute_stats()


def _conv_gp(s, dev):
    from .models.gp import gp as GP
    dt = config.np_dtype()
    g = GP.__new__(GP)
    g.device = dev
    g.check_rep = bool(getattr(s, 'check_rep', True))
    g.indices = _arr(getattr(s, 'indices', None))
    g.X = _arr(s.X, dt)
    g.Y = _arr(s.Y, dt)
    g.W_diag = _arr(getattr(s, 'W_diag', None), dt)
    g.sum_residual = _arr(getattr(s, 'sum_residual', None), dt)
    g.kernel = _conv_kernel(s.kernel, dev)
    g.vecch = bool(getattr(s, 'vecch', False))
    g.n_data = g.X.shape[0]
    g.m = int(getattr(s, 'm', 25) or 25)
    g.ord_fun = None
    if g.vecch:
        g.kernel.ord_nn()
    else:
        g.kernel.compute_stats()
    return g


def _conv_dgp(s, dev):
    from .models.dgp import dgp as DGP
    from .models.imputation import imputer
    dt = config.np_dtype()
    m = DGP.__new__(DGP)
    m.device = dev
    m.Y = _arr(s.Y) if np.issubdtype(np.asarray(s.Y).dtype, np.integer) \
        else _arr(s.Y, dt)
    m.check_rep = bool(getattr(s, 'check_rep', True))
    m.indices = _arr(getattr(s, 'indices', None))
    m.counts = _arr(getattr(s, 'counts', None))
    m.X = _arr(s.X, dt)
    m.vecch = bool(getattr(s, 'vecch', False))
    m.n_data = m.X.shape[0]
    m.nn_method = getattr(s, 'nn_method', 'exact')
    m.m = int(getattr(s, 'm', 25) or 25)
    m.ord_fun = None
    m.all_layer = _conv_layers(s.all_layer, dev)
    m.n_layer = len(m.all_layer)
    m.block = bool(getattr(s, 'block', True))
    m.imp = imputer(m.all_layer, m.block, dev)
    if m.vecch:
        m.imp.update_ord_nn()
    m.N = int(getattr(s, 'N', 0) or 0)
    m.burnin = getattr(s, 'burnin', None)
    return m


def _conv_emulator(s, dev):
    from .models.emulation import emulator as Emu
    from .models.imputation import imputer
    e = Emu.__new__(Emu)
    e.device = dev
    e._ens = None
    e.all_layer = _conv_layers(s.all_layer, dev)
    e.n_layer = len(e.all_layer)
    e.vecch = bool(e.all_layer[0][0].vecch)
    e.block = bool(getattr(s, 'block', True))
    e.imp = imputer(e.all_layer, e.block, dev)
    e.all_layer_set = []
    for one in getattr(s, 'all_layer_set', []):
        conv = _conv_layers(one, dev)
        _refresh_stats(conv)
        e.all_layer_set.append(conv)
    if not e.all_layer_set:
        raise ValueError("saved dgpsi emulator carries no imputations")
    return e


def _conv_container(s, dev):
    from .models.linkgp import container as Cont
    from .models.imputation import imputer
    c = Cont.__new__(Cont)
    c.device = dev
    c.type = s.type
    if s.type == 'gp':
        c.structure = _conv_kernel(s.structure, dev)
        c.vecch = bool(c.structure.vecch)
        if c.vecch:
            c.structure.ord_nn()
        else:
            c.structure.compute_stats()
    else:
        c.structure = _conv_layers(s.structure, dev)
        c.vecch = bool(c.structure[0][0].vecch)
        c.imp = imputer(c.structure, True, dev)
        if c.vecch:
            c.imp.update_ord_nn()
    li = getattr(s, 'local_input_idx', None)
    c.local_input_idx = [_arr(x) for x in li] if isinstance(li, list) \
        else _arr(li)
    return c


def _conv_lgp(s, dev):
    from .models.linkgp import lgp as Lgp
    g = Lgp.__new__(Lgp)
    g.device = dev
    g.L = int(s.L)
    g.all_layer = [[_conv_container(c, dev) for c in layer] for layer in s.all_layer]
    g.num_model = [len(g.all_layer[l]) for l in range(1, g.L)]
    g.all_layer_set = []
    for one in getattr(s, 'all_layer_set', []):
        conv_imp = []
        for layer in one:
            conv_layer = []
            for cont in layer:
                c = _conv_container(cont, dev)
                if c.type == 'dgp':
                    _refresh_stats(c.structure)
                conv_layer.append(c)
            conv_imp.append(conv_layer)
        g.all_layer_set.append(conv_imp)
    if not g.all_layer_set:
        raise ValueError("saved dgpsi lgp carries no imputations")
    return g


_TOP = {'gp': _conv_gp, 'dgp': _conv_dgp, 'emulator': _conv_emulator,
        'container': _conv_container, 'lgp': _conv_lgp,
        'kernel': _conv_kernel}


def read_dgpsi(pkl_file, device=None):
    """Load a dgpsi-saved ``.pkl`` checkpoint as the equivalent
    dgp_tpu_torch object, on ``device`` (default: the card; reference
    writer: `dgpsi/utils.py:18`)."""
    dev = config.resolve_device(device)
    stub = _load_stub_graph(pkl_file)
    name = _clsname(stub)
    if name in _TOP:
        return _TOP[name](stub, dev)
    if name in _LIK_NAMES:
        return _conv_likelihood(stub)
    raise ValueError(f"unsupported top-level dgpsi object: {name!r} "
                     f"(supported: {sorted(_TOP)})")
