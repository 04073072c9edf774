"""Persistence, summaries, thread shims and host-side helpers of the model
classes; the counterpart of `dgp_tpu/utils.py`.

`write`/`read` persist a gp, dgp, emulator, container or lgp with pickle:
the object graph is numpy and plain values once the engines and tensor
caches (an imputer's ``_compiled``, an emulator's ``_ens``) are taken off,
so a file written on the card loads on a machine without one; `read` puts
the objects on the device it is given.  `summary` prints the JAX package's
tables with a small table printer of its own (the JAX package uses
`tabulate`).  Also the latent initialisers of narrowing layers
(sigmoid-kernel PCA, exact and Nystrom), the label encoder of the
Categorical likelihood and the nested-list shape check of
`lgp.set_vecchia`; the exact kernel PCA and the encoder stand in for
scikit-learn's `KernelPCA(kernel='sigmoid')` and `LabelEncoder`, which the
JAX package imports.  `multistart` maximises an objective from many starts
as one batched bounded L-BFGS on the card.  ``nb_seed`` (rng.py) is
importable from here too, as from the JAX package's utils.
"""
import pickle
import warnings

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import config
from .ops import lbfgs
from .rng import nb_seed  # noqa: F401  (dgp_tpu/utils.py:66 defines it here)

#: attributes that hold an engine or tensors built from the rest of the
#: object, rebuilt on demand
_CACHES = ('_compiled', '_ens')


# ----------------------------------------------------------------------
# persistence
# ----------------------------------------------------------------------
def _walk(obj):
    """Every object reachable from obj through attributes, lists, tuples
    and dict values, once each."""
    seen, stack = set(), [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif hasattr(o, '__dict__') and not isinstance(o, type):
            yield o
            stack.extend(o.__dict__.values())


class _Pickler(pickle.Pickler):
    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError("write: the object still holds a torch.Tensor; only "
                            "numpy state is saved")
        return None


def write(emu, pkl_file):
    """Save a gp, dgp, emulator, container or lgp to ``<pkl_file>.pkl``
    (utils.py:18), without its engines and tensor caches, which are put
    back afterwards."""
    stripped = []
    for o in _walk(emu):
        for attr in _CACHES:
            if o.__dict__.get(attr) is not None:
                stripped.append((o, attr, o.__dict__[attr]))
                setattr(o, attr, None)
    try:
        with open(pkl_file + ".pkl", "wb") as f:
            _Pickler(f).dump(emu)
    finally:
        for o, attr, value in stripped:
            setattr(o, attr, value)


def read(pkl_file, device=None):
    """Load an object saved by `write` (utils.py:30) with every part of it
    on ``device`` (default: the card)."""
    dev = config.resolve_device(device)
    with open(pkl_file + ".pkl", "rb") as f:
        obj = pickle.load(f)
    for o in _walk(obj):
        if 'device' in o.__dict__:
            o.device = dev
    return obj


# ----------------------------------------------------------------------
# thread API parity
# ----------------------------------------------------------------------
_thread_count = 1


def get_thread():
    """Thread-count parity shim (reference utils.get_thread)."""
    return _thread_count


def set_thread(value):
    """Thread-count parity shim (reference utils.set_thread): recorded for
    API compatibility; the device runs the parallel work."""
    global _thread_count
    _thread_count = int(value)


# ----------------------------------------------------------------------
# summary tables
# ----------------------------------------------------------------------
_FORMATS = {
    # top, header rule, row rule, bottom: (left, fill, join, right); bar
    'fancy_grid': (('╒', '═', '╤', '╕'), ('╞', '═', '╪', '╡'),
                   ('├', '─', '┼', '┤'), ('╘', '═', '╧', '╛'), '│'),
    'grid': (('+', '-', '+', '+'), ('+', '=', '+', '+'), ('+', '-', '+', '+'),
             ('+', '-', '+', '+'), '|'),
}


def _table(info, tablefmt='fancy_grid'):
    """The rows of ``info`` (the first the header) as a grid of
    left-aligned cells; a cell may hold several lines."""
    if tablefmt not in _FORMATS:
        raise ValueError(f"tablefmt must be one of {sorted(_FORMATS)}")
    top, head, rule, bottom, bar = _FORMATS[tablefmt]
    cells = [[str(c).split('\n') for c in row] for row in info]
    widths = [max(len(line) for row in cells for line in row[j])
              for j in range(len(info[0]))]

    def border(b):
        return b[0] + b[2].join(b[1] * (w + 2) for w in widths) + b[3]

    def lines(row):
        h = max(len(c) for c in row)
        return [bar + bar.join(f" {(c[i] if i < len(c) else ''):<{w}} "
                               for c, w in zip(row, widths)) + bar for i in range(h)]

    out = [border(top)] + lines(cells[0]) + [border(head)]
    for i, row in enumerate(cells[1:]):
        if i:
            out.append(border(rule))
        out += lines(row)
    return '\n'.join(out + [border(bottom)])


def _fmt(x, fixed=False):
    s = np.array2string(np.atleast_1d(x)[0], precision=3, floatmode='fixed')
    return f"{s} (fixed)" if fixed else s


def _lengths(x):
    return np.array2string(x, precision=3, floatmode='fixed', separator=', ')


def summary_rows(obj):
    """(rows, notes) of `summary`: the table's rows, the header first, and
    the lines printed under it (utils.py:101-198); None for a trained dgp,
    which is summarised through its emulator."""
    name = type(obj).__name__
    if name == 'kernel':
        return [['Kernel Fun', 'Length-scale(s)', 'Variance', 'Nugget'],
                ['Squared-Exp' if obj.name == 'sexp' else 'Matern-2.5', _lengths(obj.length),
                 _fmt(obj.scale, not obj.scale_est),
                 _fmt(obj.nugget, not obj.nugget_est)]], []
    if name == 'gp':
        k = obj.kernel
        dims = (np.array2string(k.input_dim + 1, separator=', ') if k.connect is None
                else np.array2string(np.concatenate((k.input_dim + 1, k.connect + 1)),
                                     separator=', '))
        return ([['Kernel Fun', 'Length-scale(s)', 'Variance', 'Nugget', 'Input Dims'],
                 ['Squared-Exp' if k.name == 'sexp' else 'Matern-2.5', _lengths(k.length),
                  _fmt(k.scale, not k.scale_est), _fmt(k.nugget, not k.nugget_est), dims]],
                ["'Input Dims' indicates the dimensions (i.e., column indices) of "
                 "your input data that are used for GP emulator training."])
    if name in ('dgp', 'emulator'):
        if name == 'dgp' and obj.N != 0:
            return None
        info = [['Layer No.', 'Node No.', 'Type', 'Length-scale(s)', 'Variance',
                 'Nugget', 'Input Dims', 'Global Connection']]
        for l, layer in enumerate(obj.all_layer):
            for k, nd in enumerate(layer):
                is_lik = nd.type == 'likelihood'
                t = ('GP (Squared-Exp)' if nd.name == 'sexp'
                     else 'GP (Matern-2.5)' if nd.name == 'matern2.5'
                     else f'Likelihood ({nd.name})')
                dims = np.array2string(np.asarray(nd.input_dim) + 1, separator=', ')
                if l == 0 and not is_lik and nd.connect is not None:
                    dims = np.array2string(np.concatenate((nd.input_dim + 1,
                                                           nd.connect + 1)), separator=', ')
                conn = ('NA' if is_lik else 'No' if l == 0
                        else np.array2string(nd.connect + 1, separator=', ')
                        if nd.connect is not None else 'No')
                info.append([f'Layer {l+1}', f'Node {k+1}', t,
                             'NA' if is_lik else _lengths(nd.length),
                             'NA' if is_lik else _fmt(nd.scale, not nd.scale_est),
                             'NA' if is_lik else _fmt(nd.nugget, not nd.nugget_est),
                             dims, conn])
        return info, ["1. 'Input Dims' presents the indices of GP nodes in the feeding "
                      "layer whose outputs feed into the GP node.",
                      "2. 'Global Connection' indicates the dimensions (i.e., column "
                      "indices) of the global input data used as additional inputs."]
    if name == 'lgp':
        all_layer = obj.all_layer
        info = [['Layer No.', 'Emulator No.', 'Type', 'Connection', 'External Inputs']]
        for l, layer in enumerate(all_layer):
            for k, cont in enumerate(layer):
                if l == 0:
                    links = ("Global input: " + np.array2string(
                        np.asarray(cont.local_input_idx) + 1, separator=', '))
                    external = 'No'
                else:
                    local_input_idx = (cont.local_input_idx
                                       if isinstance(cont.local_input_idx, list)
                                       else [None] * (l - 1) + [cont.local_input_idx])
                    links = ''
                    for i, idx in enumerate(local_input_idx):
                        if idx is None:
                            continue
                        emu_idx, out_idx = [], []
                        for cnt, feeding in enumerate(all_layer[i]):
                            n = 1 if feeding.type == 'gp' else len(feeding.structure[-1])
                            emu_idx += [cnt] * n
                            out_idx += list(range(n))
                        for j in np.atleast_1d(idx):
                            links += (f"Emu {emu_idx[j]+1} in Layer {i+1}: "
                                      f"output {out_idx[j]+1}\n")
                    first = cont.structure if cont.type == 'gp' else cont.structure[0][0]
                    external = 'No' if first.connect is None else 'Yes'
                info.append([f'Layer {l+1}', f'Emu {k+1}',
                             'DGP' if cont.type == 'dgp' else 'GP', links, external])
        return info, ["1. 'Connection' gives the emulators and output dimensions linked "
                      "to each emulator.",
                      "2. 'External Inputs' indicates whether the emulator has inputs "
                      "not provided by feeding emulators."]
    raise ValueError(f"summary: no table for a {name}")


def summary(obj, tablefmt='fancy_grid'):
    """Print the table of a kernel, gp, dgp, emulator or lgp (utils.py:69):
    hyper-parameters and wiring of each node or emulator."""
    rows = summary_rows(obj)
    if rows is None:
        print('To summarise a trained DGP, construct an emulator() and summary() it.')
        return
    info, notes = rows
    print(_table(info, tablefmt))
    for line in notes:
        print(line)


class LabelEncoder:
    """Class labels <-> 0 .. K-1 in sorted order (``classes_``)."""

    def fit_transform(self, y):
        self.classes_, codes = np.unique(np.asarray(y), return_inverse=True)
        return codes.reshape(-1)

    def transform(self, y):
        y = np.asarray(y)
        codes = np.searchsorted(self.classes_, y)
        codes = np.clip(codes, 0, len(self.classes_) - 1)
        if not np.array_equal(self.classes_[codes], y):
            raise ValueError("y contains labels the encoder was not fitted on")
        return codes


def kernel_pca(X, n_components):
    """Scores of the largest ``n_components`` components of a kernel PCA
    with the sigmoid kernel tanh(x.x' / d + 1): the kernel matrix is
    double-centred, its eigenvectors scaled by the square roots of their
    eigenvalues, and each component's sign set so that its entry of largest
    magnitude is positive (what scikit-learn's KernelPCA returns)."""
    X = np.asarray(X)
    K = np.tanh(X @ X.T / X.shape[1] + 1.0)
    rows = K.mean(axis=0)
    K = K - rows[None, :] - rows[:, None] + rows.mean()
    lam, V = np.linalg.eigh(K)
    top = np.argsort(lam)[::-1][:n_components]
    lam, V = lam[top], V[:, top]
    V = V * np.sign(V[np.argmax(np.abs(V), axis=0), np.arange(V.shape[1])])
    return V * np.sqrt(np.maximum(lam, 0.0))


class NystromKPCA:
    """Nystrom-approximated kernel PCA with a sigmoid kernel, used to
    initialise narrowing latent layers at scale (role of reference
    utils.py:203-269; the construction here is the feature-space form).

    With landmarks Z, the Nystrom feature map is phi(x) = W^{-1/2} k(x, Z)
    where W = k(Z, Z).  Kernel PCA of the centred feature matrix
    Phi - mean(Phi) is then an ordinary PCA, computed from its SVD; the
    scores are U_r S_r.  Each component's sign is chosen so that its
    midrange is non-negative (the latent initialiser expects that
    orientation).  The landmarks come from numpy's global generator.
    """

    def __init__(self, n_components, m=200):
        self.m = m
        self.n_components = n_components

    def fit_transform(self, X):
        X = np.asarray(X)
        n, d = X.shape
        m = min(self.m, n)
        idx = np.random.permutation(n)[:m]
        Z = X[idx]
        gamma = 1.0 / d
        K_nm = np.tanh(gamma * (X @ Z.T) + 1.0)
        W = K_nm[idx]
        W = 0.5 * (W + W.T)
        lam, V = np.linalg.eigh(W)
        lam = np.maximum(lam, 1e-12)
        Phi = K_nm @ ((V / np.sqrt(lam)) @ V.T)
        Phi -= Phi.mean(axis=0)
        U, S, _ = np.linalg.svd(Phi, full_matrices=False)
        r = min(self.n_components, S.shape[0])
        scores = U[:, :r] * S[:r]
        if r < self.n_components:  # rank-deficient input: pad with zeros
            scores = np.pad(scores, ((0, 0), (0, self.n_components - r)))
        flip = (scores.min(axis=0) + scores.max(axis=0)) / 2 < 0
        return scores * np.where(flip, -1.0, 1.0)


def have_same_shape(list1, list2):
    """Whether two nested lists have the same nesting and lengths
    (reference utils.have_same_shape)."""
    if len(list1) != len(list2):
        return False
    for a, b in zip(list1, list2):
        if isinstance(a, list) and isinstance(b, list):
            if not have_same_shape(a, b):
                return False
        elif isinstance(a, list) or isinstance(b, list):
            return False
    return True


# ----------------------------------------------------------------------
# multistart optimisation (role of reference utils.py:271)
# ----------------------------------------------------------------------
class _NumpyUse(TorchFunctionMode):
    """Records whether an objective turns its input into a numpy array (a
    numpy objective), and lets it do so on a detached host copy."""

    def __init__(self):
        super().__init__()
        self.used = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, '__name__', '') in ('__array__', 'numpy'):
            self.used = True
            args = (args[0].detach().cpu(),) + tuple(args[1:])
        return func(*args, **(kwargs or {}))


def _torch_objective(func, x0, args):
    """Whether ``func`` returns a torch tensor that depends on its input
    without passing it through numpy: one call on the first start, as a
    (1, D) tensor that requires its gradient."""
    x = x0[None, :].clone().requires_grad_(True)
    probe = _NumpyUse()
    with torch.enable_grad(), probe, warnings.catch_warnings():
        # numpy wrapping its results in tensors warns of its own API
        warnings.simplefilter('ignore', DeprecationWarning)
        val = func(x, *args)
    return isinstance(val, torch.Tensor) and val.requires_grad and not probe.used


def multistart(func, initials, lb, up, args=(), method='L-BFGS-B', core_num=None,
               out_dim=0, int_mask=None, device=None):
    """Multistart bounded maximisation of ``func``; returns the best start
    (`dgp_tpu/utils.py:243-316`).

    ``func`` maps a (1, D) input to its values (first row; output
    ``out_dim``, or the mean over outputs with -1).  When it is written in
    torch, all starts run as one batched bounded L-BFGS on ``device``
    (default: the card; `ops.lbfgs`, 100 iterations, max(30, 20 + 5D)
    evaluations), each start's objective and gradient from
    `torch.func.vmap` of its autograd, as the JAX package vmaps its own.
    A numpy objective, or a batched result that is not finite, falls back
    to scipy's L-BFGS-B per start (a torch objective still gets tensors)
    with a RuntimeWarning; any other error propagates.  ``int_mask`` marks integer dimensions, rounded inside the
    objective and in the returned optimum (reference utils.py:311-320).
    ``core_num`` (the reference's process pool) is ignored.
    """
    initials = np.atleast_2d(np.asarray(initials, np.float64))
    lb = np.asarray(lb, np.float64)
    up = np.asarray(up, np.float64)
    D = len(lb)
    maxfun = int(max(30, 20 + 5 * D))
    mask = np.zeros(D, bool)
    if int_mask is not None:
        mask[np.asarray(int_mask)] = True
    dev = config.resolve_device(device)
    x0 = torch.as_tensor(initials, dtype=torch.float64, device=dev)
    why = None
    in_torch = _torch_objective(func, x0[0], args)
    if not in_torch:
        why = ("TypeError: the objective does not return a torch tensor that "
               "depends on its input")
    else:
        mask_t = torch.as_tensor(mask, device=dev)

        def obj(x):
            x = torch.where(mask_t, torch.round(x), x)
            v0 = func(x[None, :], *args)[0]
            v = -v0.mean() if out_dim == -1 else -v0.reshape(-1)[out_dim]
            return v.to(torch.float64)

        grad_and_value = torch.func.vmap(torch.func.grad_and_value(obj))

        def fg(x):
            g, v = grad_and_value(x)
            return v, g

        t = dict(dtype=torch.float64, device=dev)
        xs, fs, _ = lbfgs.minimize(fg, x0, torch.as_tensor(lb, **t),
                                   torch.as_tensor(up, **t), maxiter=100, maxfun=maxfun)
        xs, fs = xs.cpu().numpy(), fs.cpu().numpy()
        if not np.all(np.isfinite(fs)):
            why = "FloatingPointError: non-finite multistart objective"
    if why is not None:
        warnings.warn(f"multistart: device path failed ({why}); falling back to "
                      "scipy L-BFGS-B", RuntimeWarning)
        from scipy.optimize import Bounds, minimize as sp_minimize

        def wrapped(x, *fargs):
            x = np.atleast_2d(np.where(mask, np.round(x), x))
            v0 = func(torch.as_tensor(x, device=dev) if in_torch else x, *fargs)[0]
            return float(-v0.mean() if out_dim == -1 else -v0.reshape(-1)[out_dim])

        results = [sp_minimize(wrapped, x0_, args=args, method=method,
                               bounds=Bounds(lb, up),
                               options={'maxiter': 100, 'maxfun': maxfun})
                   for x0_ in initials]
        xs = np.asarray([r.x for r in results])
        fs = np.asarray([r.fun for r in results])
    best = xs[int(np.argmin(fs))].copy()
    best[mask] = np.round(best[mask])
    return best
