"""Linked emulation in dgp_tpu_torch against dgp_tpu, on the CPU: a node's
linked predictions (`linkgp_prediction`, `linkgp_prediction_full`; dense
and Vecchia, with and without a deterministic global input), `lgp.predict`
on dgp_tpu systems carried across with `interop.lgp_from_numpy` (gp -> gp,
gp -> dense DGP, gp -> Vecchia DGP with and without a global input in its
second layer, and two first-layer emulators feeding one with an external
input), sampling by distribution, the switch to and from Vecchia, and the parity row `linked`
(tools/parity.py:274-292) against its gate.  Values rtol 1e-9 at a nugget
of 1e-2; at 1e-4 and 1e-6 the tolerances measured for them
(`SMALL_NUGGET_TOL`).

The dgp_tpu systems are built without their imputation draws (a compiled
program per structure, minutes on the CPU): `imputer.sample` is replaced by
a no-op while they are built, and each imputation's latent layers are set
by hand, consistently (a node's input is the layer below's outputs), so
that the N imputations differ.  The predictions being compared are
deterministic given the imputations."""
import copy

import numpy as np
import pytest
import torch

import dgp_tpu
from dgp_tpu.models import imputation as jimp
import dgp_tpu_torch
from dgp_tpu_torch.interop import lgp_from_numpy, node_from_numpy, node_to_numpy
from dgp_tpu_torch.models import linkgp
from dgp_tpu_torch.ops import cuda_linked

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def f1(x):
    return (np.sin(7.5 * x) + 1) / 2


def f2(x):
    return (2 / 3 * np.sin(2 * (2 * x - 1)) + 4 / 3 * np.exp(-30 * (2 * (2 * x - 1)) ** 2)
            - 1 / 3)


class _no_sampling:
    """dgp_tpu's imputer draws nothing inside the block."""

    def __enter__(self):
        self.sample = jimp.imputer.sample
        jimp.imputer.sample = lambda self, burnin=0: None

    def __exit__(self, *exc):
        jimp.imputer.sample = self.sample


# ----------------------------------------------------------------------
# a node's linked predictions
# ----------------------------------------------------------------------
def _node(pkg, vecch, n_global, name, seed=0, n=60):
    """A GP node with trained-looking parameters on a 2-d input and
    ``n_global`` global dims."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-1, 1, (n, 2))
    Z = rs.uniform(-1, 1, (n, n_global)) if n_global else None
    nd = pkg.kernel(length=np.linspace(0.4, 0.9, 2 + n_global), scale=1.3, nugget=1e-3,
                    name=name, connect=np.arange(2, 2 + n_global) if n_global else None)
    nd.input, nd.global_input = X, Z
    nd.output = (np.sin(3 * X[:, :1]) + X[:, 1:] ** 2
                 + (0 if Z is None else np.cos(2 * Z).sum(1, keepdims=True)))
    nd.vecch = vecch
    nd.pred_m = 15
    return nd


def _queries(n_global, seed=1, M=23):
    rs = np.random.RandomState(seed)
    m = rs.uniform(-1, 1, (M, 2))
    v = rs.uniform(0.001, 0.05, (M, 2))
    z = rs.uniform(-1, 1, (M, n_global)) if n_global else None
    return m, v, z


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
@pytest.mark.parametrize("vecch,n_global", [(False, 0), (False, 1), (True, 0), (True, 1)],
                         ids=["dense", "dense-z", "vecchia", "vecchia-z"])
def test_linkgp_prediction_matches_jax(vecch, n_global, name):
    jnode = _node(dgp_tpu, vecch, n_global, name)
    tnode = node_from_numpy(node_to_numpy(jnode))
    tnode.vecch, tnode.pred_m, tnode.device = vecch, 15, 'cpu'
    m, v, z = _queries(n_global)
    ref = jnode.linkgp_prediction(m, v, z)
    out = tnode.linkgp_prediction(m, v, z)
    _close(out[0], ref[0])
    _close(out[1], ref[1])


@pytest.mark.parametrize("vecch", [False, True])
@pytest.mark.parametrize("n_global,with_z", [(1, False), (3, True)])
def test_linkgp_prediction_full_matches_jax(vecch, n_global, with_z):
    """The first global dim is Gaussian (m_z, v_z), the rest deterministic
    (z); dense whatever vecch says, in both packages."""
    jnode = _node(dgp_tpu, vecch, n_global, "sexp", seed=2)
    tnode = node_from_numpy(node_to_numpy(jnode))
    tnode.vecch, tnode.device = vecch, 'cpu'
    m, v, _ = _queries(0, seed=3)
    rs = np.random.RandomState(4)
    m_z, v_z = rs.uniform(-1, 1, (len(m), 1)), rs.uniform(0.001, 0.03, (len(m), 1))
    z = rs.uniform(-1, 1, (len(m), n_global - 1)) if with_z else None
    ref = jnode.linkgp_prediction_full(m, v, m_z, v_z, z)
    out = tnode.linkgp_prediction_full(m, v, m_z, v_z, z)
    _close(out[0], ref[0])
    _close(out[1], ref[1])


def test_linkgp_prediction_takes_queries_in_batches(monkeypatch):
    """A dense linked prediction holds (n, n) moments per query; with a
    budget of a few queries it runs in batches and gives the same values."""
    tnode = node_from_numpy(node_to_numpy(_node(dgp_tpu, False, 1, "sexp")))
    tnode.device = 'cpu'
    m, v, z = _queries(1, M=40)
    whole = tnode.linkgp_prediction(m, v, z)
    monkeypatch.setattr(cuda_linked, "LINK_BUDGET", 7 * 3 * 60 * 60 * 8)
    parts = tnode.linkgp_prediction(m, v, z)
    _close(parts[0], whole[0])
    _close(parts[1], whole[1])


# ----------------------------------------------------------------------
# linked systems carried from dgp_tpu
# ----------------------------------------------------------------------
def _jax_gp(X, Y, length, name='sexp', vecchia=False, nugget=1e-2, **kw):
    """A trained dgp_tpu gp with a fixed nugget (1e-2 unless a test of
    small nuggets asks for less: see `SMALL_NUGGET_TOL`)."""
    m = dgp_tpu.gp(X, Y, dgp_tpu.kernel(length=np.asarray(length, float), name=name,
                                        nugget=nugget, scale_est=True, **kw),
                   vecchia=vecchia, m=10)
    m.train()
    return m


def _dgp_layers(pkg, nugget=1e-2, connect=True):
    return pkg.combine(
        [pkg.kernel(length=np.array([0.5]), name='sexp', nugget=nugget)],
        [pkg.kernel(length=np.array([0.4]), name='sexp', nugget=nugget, scale=0.3,
                    connect=np.arange(1) if connect else None)])


def _perturb(system, seed):
    """Give each imputation of every DGP container its own latent layer:
    hidden outputs moved by a smooth term and the next layer's inputs set to
    them."""
    rs = np.random.RandomState(seed)
    for one in system.all_layer_set:
        for layer in one:
            for cont in layer:
                if cont.type != 'dgp':
                    continue
                for li in range(len(cont.structure) - 1):
                    for node in cont.structure[li]:
                        a, b = rs.uniform(-0.1, 0.1, 2)
                        node.output = node.output + a * np.sin(3 * node.input[:, :1] + b)
                    F = np.concatenate([nd.output for nd in cont.structure[li]], axis=1)
                    for node in cont.structure[li + 1]:
                        node.input = F[:, node.input_dim]
                for node in (nd for lay in cont.structure for nd in lay):
                    if node.type == 'gp' and not node.vecch:
                        node.compute_stats()


def _system(kind, nugget=1e-2):
    """(dgp_tpu lgp, query input) of one linked system whose nodes have the
    nugget ``nugget``."""
    dgp_tpu.nb_seed(0)
    rs = np.random.RandomState(0)
    x1 = np.linspace(0, 1, 14)[:, None]
    c1 = dgp_tpu.container(_jax_gp(x1, f1(x1), [0.5], nugget=nugget).export(),
                           local_input_idx=np.array([0]))
    xt = np.linspace(0.02, 0.98, 31)[:, None]
    if kind == "gp-gp":
        w = np.linspace(0, 1, 15)[:, None]
        c2 = dgp_tpu.container(_jax_gp(w, f2(w), [0.3], name='matern2.5').export(),
                               local_input_idx=np.array([0]))
        return dgp_tpu.lgp([[c1], [c2]], N=3), xt
    if kind == "two-inputs-external":
        ca = dgp_tpu.container(_jax_gp(x1, np.sin(np.pi * x1), [0.5]).export(),
                               local_input_idx=np.array([0]))
        cb = dgp_tpu.container(_jax_gp(x1, np.cos(np.pi * x1), [0.5]).export(),
                               local_input_idx=np.array([0]))
        W = rs.uniform(-1, 1, size=(30, 3))
        Zc = W[:, [0]] ** 2 + W[:, [1]] + 0.5 * W[:, [2]]
        mc = _jax_gp(W, Zc, [0.5, 0.5, 0.7], input_dim=np.arange(2), connect=np.array([2]))
        cc = dgp_tpu.container(mc.export(), local_input_idx=np.array([0, 1]))
        ext = np.linspace(-0.5, 0.5, len(xt))[:, None]
        return dgp_tpu.lgp([[ca, cb], [cc]], N=2), [xt, [ext]]
    vecchia = kind.startswith("gp-vecchia-dgp")
    n = 200 if vecchia else 16
    X2 = np.sort(rs.uniform(0, 1, (n, 1)), axis=0)
    Y2 = f2(X2) + 0.02 * rs.randn(n, 1)
    with _no_sampling():
        m2 = dgp_tpu.dgp(X2, Y2, _dgp_layers(dgp_tpu, nugget, kind != "gp-vecchia-dgp-latent"),
                         vecchia=vecchia, m=10)
        c2 = dgp_tpu.container(m2.estimate(), local_input_idx=np.array([0]))
        system = dgp_tpu.lgp([[c1], [c2]], N=3)
    _perturb(system, 1)
    return system, xt


SYSTEMS = ["gp-gp", "gp-dense-dgp", "gp-vecchia-dgp", "gp-vecchia-dgp-latent",
           "two-inputs-external"]
_SYSTEMS = {}


def _carried(kind):
    """The dgp_tpu system (built once per kind) and a port copy of it."""
    if kind not in _SYSTEMS:
        _SYSTEMS[kind] = _system(kind)
    system, x = _SYSTEMS[kind]
    return system, lgp_from_numpy(system, device='cpu'), x


@pytest.mark.parametrize("full_layer", [False, True])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_lgp_predict_matches_jax(kind, full_layer):
    """mean_var of the port against dgp_tpu's lgp on the same
    imputations."""
    system, port, x = _carried(kind)
    ref = system.predict(x, m=20, full_layer=full_layer)
    out = port.predict(x, m=20, full_layer=full_layer)
    flat = (lambda r: [a for lay in r for a in lay]) if full_layer else list
    assert len(flat(out[0])) == len(flat(ref[0])) > 0
    for o, r in zip(flat(out[0]) + flat(out[1]), flat(ref[0]) + flat(ref[1])):
        _close(o, r)


# the port against dgp_tpu at small nuggets (both in float64 on this CPU,
# measured over the five systems): at 1e-4 the means agree to 2.4e-8 and
# the variances to 5.8e-5 relative; at 1e-6 the means to 2.1e-6, while the
# variances (down to 2e-7) differ by up to 3.4x -- a linked variance is a
# difference of terms as large as Rinv's entries, and the two packages
# factor with different Cholesky routines.
SMALL_NUGGET_TOL = {1e-4: (dict(rtol=1e-7, atol=0.0), dict(rtol=3e-4, atol=0.0)),
                    1e-6: (dict(rtol=1e-5, atol=0.0), None)}


@pytest.mark.parametrize("nugget", [1e-4, 1e-6])
@pytest.mark.parametrize("kind", SYSTEMS)
def test_lgp_predict_at_small_nuggets(kind, nugget):
    """mean_var of the carried systems with every nugget at ``nugget``:
    the port against dgp_tpu at the tolerances measured above (variances
    at 1e-6: finite and positive only)."""
    system, x = _system(kind, nugget)
    port = lgp_from_numpy(system, device='cpu')
    ref = system.predict(x, m=20)
    out = port.predict(x, m=20)
    tol_mean, tol_var = SMALL_NUGGET_TOL[nugget]
    for o, r in zip(out[0], ref[0]):
        _close(o, r, **tol_mean)
    for o, r in zip(out[1], ref[1]):
        if tol_var is not None:
            _close(o, r, **tol_var)
        assert np.isfinite(o).all() and (o > 0).all()


def test_lgp_sampling_matches_mean_var():
    """Samples of the gp -> dense DGP system (S per imputation): at every
    query the sample mean lies within 4 sd / sqrt(S N) of the mean_var mean,
    sd the draws' own.  (As in dgp_tpu and dgpsi, a DGP container's last-
    layer GP draws take the layer below's variance, so the sample variance
    is not the mean_var variance.)"""
    _, port, x = _carried("gp-dense-dgp")
    mu, _ = port.predict(x, m=20)
    np.random.seed(11)
    S = 400
    s = port.predict(x, method='sampling', sample_size=S)
    assert s[0].shape == (1, len(x), S * len(port.all_layer_set))
    draws = s[0][0]
    bound = 4 * draws.std(axis=1) / np.sqrt(draws.shape[1])
    assert np.all(np.abs(draws.mean(axis=1) - mu[0][:, 0]) <= bound)
    full = port.predict(x, method='sampling', sample_size=5, full_layer=True)
    assert [lay[0].shape for lay in full] == [(1, len(x), 5 * 3)] * 2


def test_set_vecchia_round_trip_matches_jax():
    """The gp -> Vecchia DGP system switched to dense and back: the dense
    predictions match dgp_tpu's after the same switch, and switching back
    gives the Vecchia predictions again."""
    system, x = _system("gp-vecchia-dgp")
    port = lgp_from_numpy(system, device='cpu')
    before = port.predict(x, m=20)
    port.set_vecchia(False)
    system.set_vecchia(False)
    assert not any(nd.vecch for one in port.all_layer_set for layer in one for c in layer
                   for nd in linkgp._gp_nodes(c.structure))
    dense, ref = port.predict(x, m=20), system.predict(x, m=20)
    _close(dense[0][0], ref[0][0])
    _close(dense[1][0], ref[1][0])
    port.set_vecchia([[True], [True]])
    again = port.predict(x, m=20)
    _close(again[0][0], before[0][0])
    _close(again[1][0], before[1][0])
    with pytest.raises(Exception, match="different shape"):
        port.set_vecchia([[True]])


def test_container_wiring_and_refusals():
    _, port, x = _carried("gp-gp")
    c = port.all_layer[1][0]
    cp = c.set_local_input(np.array([0]), new=True)
    assert cp is not c and cp.structure is c.structure and cp.device == c.device
    c2 = copy.copy(c)
    assert c2.local_input_idx is not c.local_input_idx
    # O7: ppredict and predict(sharded=True) are the plain call
    ref = port.predict(x)
    for out in (port.ppredict(x, chunk_num=2, core_num=2), port.predict(x, sharded=True)):
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def test_port_builds_and_predicts_a_linked_system():
    """The port's own path at a small size: a trained Vecchia gp and a
    Vecchia DGP, container() draws the DGP's burn-in, lgp(N=3) one sweep
    per imputation, and predict gives finite moments close to f2(f1(x))."""
    rs = np.random.RandomState(0)
    X1 = rs.uniform(-1, 1, (150, 1))
    Y1 = f1(X1) + 0.01 * rs.randn(150, 1)
    X2 = rs.uniform(0, 1, (150, 1))
    Y2 = f2(X2) + 0.05 * rs.randn(150, 1)
    dgp_tpu_torch.nb_seed(3)
    g = dgp_tpu_torch.gp(X1, Y1, dgp_tpu_torch.kernel(length=np.array([1.]), name='matern2.5',
                                                      scale_est=True, nugget_est=True),
                         vecchia=True, m=10, device='cpu')
    g.train()
    m2 = dgp_tpu_torch.dgp(X2, Y2, _dgp_layers(dgp_tpu_torch), vecchia=True, m=10,
                           device='cpu')
    m2.train(N=10, disable=True)
    c1 = dgp_tpu_torch.container(g.export(), local_input_idx=np.array([0]), device='cpu')
    c2 = dgp_tpu_torch.container(m2.estimate(), local_input_idx=np.array([0]), device='cpu')
    system = dgp_tpu_torch.lgp([[c1], [c2]], N=3, device='cpu')
    outs = [one[1][0].structure[0][0].output for one in system.all_layer_set]
    assert not np.array_equal(outs[0], outs[1])           # one sweep each
    assert all(c.device == system.device and nd.device == system.device
               for one in system.all_layer_set for layer in one for c in layer
               for nd in linkgp._gp_nodes(c.structure))
    z = np.linspace(-1, 1, 100)[:, None]
    mu, var = system.predict(z, m=30)
    assert np.isfinite(mu[0]).all() and (var[0] > 0).all()
    assert np.sqrt(np.mean((mu[0] - f2(f1(z))) ** 2)) < 0.1


def test_parity_row_linked_meets_its_gate():
    """tools/parity.py's `linked` row (model_linking.ipynb cells 16-28) on
    the port: a gp on f1 (n = 9) feeding a dense two-layer DGP on f2
    (n = 11, train(N=500)); the RMSE against f2(f1(z)) at most 1.25x
    dgpsi's 0.0727 (REF_ANCHORS.json)."""
    tp = dgp_tpu_torch
    tp.nb_seed(99)
    # tools/parity_data.linked_data
    X1 = np.linspace(0, 1., 9)[:, None]
    Y1 = f1(X1)
    X2 = np.linspace(0, 1., 11)[:, None]
    Y2 = f2(X2)
    z = np.linspace(0, 1, 300)[:, None]
    truth = f2(f1(z)).reshape(-1, 1)
    m1 = tp.gp(X1, Y1, tp.kernel(length=np.array([1.]), name='matern2.5', scale_est=True),
               device='cpu')
    m1.train()
    c1 = tp.container(m1.export(), local_input_idx=np.array([0]), device='cpu')
    all_layer = tp.combine(
        [tp.kernel(length=np.array([1.]), name='matern2.5')],
        [tp.kernel(length=np.array([1.]), name='matern2.5', scale_est=True,
                   connect=np.arange(1))])
    m2 = tp.dgp(X2, [Y2], all_layer, device='cpu')
    m2.train(N=500, disable=True)
    c2 = tp.container(m2.estimate(), local_input_idx=np.array([0]), device='cpu')
    ml, vl = tp.lgp([[c1], [c2]], device='cpu').predict(z)
    rmse = float(np.sqrt(np.mean((ml[0].flatten() - truth.flatten()) ** 2)))
    assert rmse <= 1.25 * 0.0727, rmse
