"""The likelihood layer of dgp_tpu_torch against dgp_tpu, in float64 on the
CPU: the tensor log-likelihoods (rtol 1e-9; a leading candidate axis against
single calls, 1e-12), Owen's T and the host classes (1e-12), the moment
formulas against Monte Carlo (the cases of tests/test_likelihood_links.py
that need no reference library), the exact Hetero-mean draws on shared
normals (1e-8) and against the closed-form posterior, the neighbour sets of
the Vecchia draw, the latent initialisers (1e-12; the Hetero one, with two
trained pilot gps between, 1e-5), the kernel PCA against scikit-learn's
(1e-8 up to sign), the engine's log-likelihoods on carried states (1e-9) and
one M-step under a likelihood node (1e-6), stationarity of the samplers with
a likelihood term, the emulator's `predict` and `nllik` on carried
imputations (1e-8), and the whole slice at a small size."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.special import expit
from scipy.stats import norm

import dgp_tpu
from dgp_tpu import likelihoods as jlik
from dgp_tpu.models import imputation as jimp
from dgp_tpu.ops.special import owens_t as j_owens_t
from dgp_tpu.vecchia import core as jcore
import dgp_tpu_torch
from dgp_tpu_torch import likelihoods as tlik
from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models.compiled import CompiledDGP, _Shares
from dgp_tpu_torch.ops import kernels as tkops
from dgp_tpu_torch.ops.special import owens_t
from dgp_tpu_torch.vecchia import core as tcore
from dgp_tpu_torch.vecchia import nn as tnn

torch.set_num_threads(1)

FAMILIES = ("Poisson", "Hetero", "NegBin", "ZIP", "ZINB")
N_LATENT = {"Poisson": 1, "Hetero": 2, "NegBin": 2, "ZIP": 2, "ZINB": 3}


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ----------------------------------------------------------------------
# 1. tensor log-likelihoods
# ----------------------------------------------------------------------
def _llik_case(case, n=60, seed=0):
    """(name, kwargs, f (n, Q), y (n, 1)) with |f| up to 40 in the columns
    that reach a softplus, a logistic or a normal tail."""
    rs = np.random.RandomState(seed)
    big = np.linspace(-40, 40, n) * rs.choice([-1, 1], n)
    counts = rs.poisson(3.0, (n, 1)).astype(float)
    counts[::5] = 0.0
    if case == "Poisson":
        return case, {}, rs.uniform(-4, 4, (n, 1)), counts
    if case == "Hetero":
        return case, {}, np.column_stack([rs.randn(n), big / 4]), rs.randn(n, 1)
    if case == "NegBin":
        return case, {}, np.column_stack([big - 1.0, rs.uniform(-2, 2, n)]), counts
    if case == "ZIP":
        return case, {}, np.column_stack([rs.uniform(-3, 3, n), big]), counts
    if case == "ZINB":
        return case, {}, np.column_stack([big / 2, rs.uniform(-2, 2, n),
                                          big[::-1]]), counts
    link = case.split("-")[1]
    if link in ("logit", "probit"):
        f = (big if link == "logit" else big / 5)[:, None]
        return ("Categorical", dict(num_classes=2, link=link), f,
                (rs.rand(n, 1) < 0.5).astype(float))
    return ("Categorical", dict(num_classes=4, link=link, robustmax_eps=1e-3),
            rs.randn(n, 4) * 10, rs.randint(0, 4, (n, 1)).astype(float))


LLIK_CASES = FAMILIES + ("Categorical-logit", "Categorical-probit",
                         "Categorical-softmax", "Categorical-robustmax")


@pytest.mark.parametrize("case", LLIK_CASES)
def test_tensor_llik_matches_jax(case):
    name, kw, f, y = _llik_case(case)
    ref = float(jlik.llik_fn(name, **kw)(jnp.asarray(f), jnp.asarray(y)))
    out = tlik.llik_fn(name, **kw)(_t(f), _t(y))
    assert out.dtype == torch.float64 and out.shape == ()
    np.testing.assert_allclose(float(out), ref, rtol=1e-9)


@pytest.mark.parametrize("case", LLIK_CASES)
def test_tensor_llik_candidate_axis(case):
    """Nine candidates in one call give what nine single calls give."""
    name, kw, f, y = _llik_case(case, seed=1)
    rs = np.random.RandomState(2)
    cands = f[None] * rs.uniform(0.5, 1.0, (9, 1, 1)) + 0.1 * rs.randn(9, *f.shape)
    fn = tlik.llik_fn(name, **kw)
    out = fn(_t(cands), _t(y))
    assert out.shape == (9,)
    np.testing.assert_allclose(out.numpy(), [float(fn(_t(c), _t(y))) for c in cands],
                               rtol=1e-12)


def test_owens_t_matches_jax():
    rs = np.random.RandomState(3)
    h, a = rs.randn(50) * 2, rs.uniform(0.01, 1.0, 50)
    ref = np.asarray(j_owens_t(jnp.asarray(h), jnp.asarray(a)))
    np.testing.assert_allclose(owens_t(_t(h), _t(a)).numpy(), ref, rtol=1e-12)
    out = owens_t(h, a)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, ref, rtol=1e-12)


# ----------------------------------------------------------------------
# 2. the host classes
# ----------------------------------------------------------------------
def _mv(seed, n, k, m_scale=1.5, v_max=1.5):
    rs = np.random.RandomState(seed)
    return m_scale * rs.randn(n, k), v_max * rs.rand(n, k) + 0.01


def _class_pair(case):
    if case in FAMILIES:
        return getattr(tlik, case)(), getattr(jlik, case)(), N_LATENT[case]
    link = case.split("-")[1]
    K = 2 if link in ("logit", "probit") else 4
    kw = dict(num_classes=K, link=link)
    return tlik.Categorical(**kw), jlik.Categorical(**kw), (1 if K == 2 else K)


@pytest.mark.parametrize("case", LLIK_CASES)
def test_class_methods_match_jax(case):
    ours, ref, q = _class_pair(case)
    rs = np.random.RandomState(4)
    n = 30
    m, v = _mv(5, n, q, m_scale=0.8, v_max=0.8)
    if case.startswith("Categorical"):
        y = rs.randint(0, ours.num_classes, (n, 1))
        f3 = rs.randn(n, 6, q)
        if ours.num_classes == 2:
            y = y.astype(float)
            f3 = f3[:, :, 0]
    else:
        y = rs.poisson(2.0, (n, 1)).astype(float) if case != "Hetero" else rs.randn(n, 1)
        f3 = rs.randn(n, 6, q) * 0.5
        if case == "Poisson":
            f3 = f3[:, :, 0]
    yb = y if f3.ndim == 2 else y[:, None, :]
    np.testing.assert_allclose(ours.pllik(yb, f3), ref.pllik(yb, f3), rtol=1e-12)
    ours.input, ours.output = m, y
    ref.input, ref.output = m, y
    np.testing.assert_allclose(ours.llik(), ref.llik(), rtol=1e-12)
    for lik in (ours, ref):
        np.random.seed(42)
        lik.res = lik.prediction(m, v) if case != "Poisson" else lik.prediction(m[:, 0], v[:, 0])
    for a, b in zip(ours.res, ref.res):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)
    for lik in (ours, ref):
        np.random.seed(43)
        lik.res = lik.sampling(m if q > 1 or case.startswith("Categorical") else m[:, 0])
    np.testing.assert_allclose(ours.res, ref.res, rtol=1e-12)
    assert ours.type == 'likelihood' and ours.name == ref.name
    np.testing.assert_array_equal(ours.exact_post_idx, ref.exact_post_idx)


def test_binary_probit_moments_vs_mc():
    """E[Phi(f)] = Phi(m/sqrt(1+v)) and the Owen's-T second moment
    E[Phi(f)^2] = Phi(t) - 2*T(t, 1/sqrt(1+2v)) must match MC."""
    m = np.array([[-1.2], [0.0], [0.7], [2.0]])
    v = np.array([[0.3], [1.1], [0.6], [2.0]])
    y_mean, y_var = tlik.Categorical(num_classes=2, link='probit').prediction(m, v)
    rs = np.random.RandomState(0)
    S = 400_000
    f = m.flatten()[:, None] + np.sqrt(v.flatten())[:, None] * rs.randn(4, S)
    p = norm.cdf(f)
    np.testing.assert_allclose(y_mean.flatten(), p.mean(1), atol=4e-3)
    np.testing.assert_allclose(y_var.flatten(), p.var(1), atol=4e-3)


def test_binary_logit_mean_vs_mc():
    m = np.array([[-1.5], [0.0], [0.8], [1.8]])
    v = np.array([[0.4], [1.0], [0.7], [1.5]])
    y_mean, y_var = tlik.Categorical(num_classes=2, link='logit').prediction(m, v)
    rs = np.random.RandomState(1)
    S = 400_000
    f = m.flatten()[:, None] + np.sqrt(v.flatten())[:, None] * rs.randn(4, S)
    p = expit(f)
    np.testing.assert_allclose(y_mean.flatten(), p.mean(1), atol=2e-2)
    assert np.all(y_var.flatten() <= p.mean(1) * (1 - p.mean(1)) + 1e-12)


def test_robustmax_prediction_vs_independent_mc():
    K = 3
    m = np.array([[1.0, 0.0, -0.5], [0.0, 0.0, 0.0], [-1.0, 2.0, 0.0]])
    v = 0.5 * np.ones((3, K))
    lik = tlik.Categorical(num_classes=K, link='robustmax', robustmax_eps=1e-3)
    np.random.seed(11)
    y_mean, _ = lik.prediction(m, v)
    np.testing.assert_allclose(y_mean.sum(axis=1), 1.0, rtol=1e-12)
    rs = np.random.RandomState(12)
    S = 200_000
    f = m[:, None, :] + np.sqrt(v)[:, None, :] * rs.randn(3, S, K)
    q = np.zeros((3, K))
    np.add.at(q, (np.arange(3)[:, None], np.argmax(f, axis=2)), 1.0)
    q /= S
    eps = 1e-3
    np.testing.assert_allclose(y_mean, eps / (K - 1) + (1 - eps - eps / (K - 1)) * q,
                               atol=0.06)


def test_robustmax_llik_and_sampling():
    K, eps = 4, 1e-3
    lik = tlik.Categorical(num_classes=K, link='robustmax', robustmax_eps=eps)
    f = np.array([[3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 5.0]])
    y_right, y_wrong = np.array([[0.0], [3.0]]), np.array([[1.0], [0.0]])
    np.testing.assert_allclose(lik._llik_np(f, y_right), 2 * np.log(1 - eps), rtol=1e-12)
    np.testing.assert_allclose(lik._llik_np(f, y_wrong), 2 * np.log(eps / (K - 1)),
                               rtol=1e-12)
    # the tensor form on the same labels
    fn = tlik.llik_fn('Categorical', num_classes=K, link='robustmax', robustmax_eps=eps)
    np.testing.assert_allclose(float(fn(_t(f), _t(y_right))), 2 * np.log(1 - eps),
                               rtol=1e-12)
    s = lik.sampling(f)
    assert s.shape == f.shape
    np.testing.assert_allclose(s.sum(axis=1), 1.0, rtol=1e-9)
    assert (s.max(axis=1) == 1 - eps).all()


@pytest.mark.parametrize("cls,k", [("ZIP", 2), ("ZINB", 3)])
def test_zi_moments_vs_mc(cls, k):
    """ZIP/ZINB predictive moments against brute-force latent MC: the mean
    to 5%, the variance (delta-method terms) to 30%."""
    lik = getattr(tlik, cls)()
    rs = np.random.RandomState(13)
    n = 5
    m = 0.6 * rs.randn(n, k)
    v = 0.5 * rs.rand(n, k) + 0.05
    y_mean, y_var = lik.prediction(m, v)
    S = 200_000
    f = m[:, None, :] + np.sqrt(v)[:, None, :] * rs.randn(n, S, k)
    if cls == "ZIP":
        lam, pi = np.exp(f[:, :, 0]), expit(f[:, :, 1])
        cm = (1 - pi) * lam
        cv = (1 - pi) * lam * (1 + pi * lam)
    else:
        mu, nn, pi = np.exp(f[:, :, 0]), np.exp(-f[:, :, 1]), expit(f[:, :, 2])
        cm = (1 - pi) * mu
        cv = (1 - pi) * (mu + mu * mu / nn) + pi * (1 - pi) * mu * mu
    np.testing.assert_allclose(y_mean, cm.mean(1), rtol=0.05)
    np.testing.assert_allclose(y_var, cv.mean(1) + cm.var(1), rtol=0.30)


# ----------------------------------------------------------------------
# 3. small models of both packages on the same data
# ----------------------------------------------------------------------
def _k(pkg, name, **kw):
    return pkg.kernel(length=np.array([0.3]), name=name, **kw)


def _family_data(family, rep, n_sites=20, seed=0):
    """(X, Y, a function making the layers): n_sites inputs of [0, 1], each twice or
    three times with ``rep``."""
    rs = np.random.RandomState(seed)
    X = np.linspace(0, 1, n_sites)[:, None]
    if rep:
        X = np.concatenate([X, X, X[::2]])
    x = X[:, 0]
    if family == "Hetero":
        Y = np.sin(5 * x) + 0.1 * np.exp(x) * rs.randn(len(x))
    elif family == "Categorical":
        Y = (rs.rand(len(x)) < norm.cdf(2 * np.sin(5 * x))).astype(int)
    elif family == "Categorical3":
        Y = np.array([3, 7, 9])[np.clip((3 * x).astype(int) + rs.randint(0, 2, len(x)),
                                              0, 2)]
    else:
        Y = rs.poisson(np.exp(1 + np.sin(5 * x)) * (rs.rand(len(x)) > 0.2)).astype(float)
    q = {"Categorical": 1, "Categorical3": 3}.get(family) or N_LATENT[family]
    name = 'sexp' if family == "Hetero" else 'matern2.5'

    def layers(pkg):
        lik = (pkg.Categorical() if family.startswith("Categorical")
               else getattr(pkg, family)())
        hidden = [_k(pkg, name, scale_est=True, connect=np.arange(1), nugget=1e-2)
                  for _ in range(q)]
        return pkg.combine([_k(pkg, name, nugget=1e-2)], hidden, [lik])
    return X, Y.reshape(-1, 1), layers


_JAX_MODELS = {}


def _jax_model(family, vecchia=False, rep=False):
    """A dgp_tpu model at its initial latents: the initial imputation (a
    compiled program per structure) is left out."""
    key = (family, vecchia, rep)
    if key not in _JAX_MODELS:
        X, Y, layers = _family_data(family, rep)
        dgp_tpu.nb_seed(5)
        sample = jimp.imputer.sample
        jimp.imputer.sample = lambda self, burnin=0: None
        try:
            _JAX_MODELS[key] = dgp_tpu.dgp(X, Y, layers(dgp_tpu), vecchia=vecchia, m=8)
        finally:
            jimp.imputer.sample = sample
    return _JAX_MODELS[key]


def _engines(family, vecchia=False, rep=False, block=True):
    """The JAX engine and a port engine on the same carried state."""
    model = _jax_model(family, vecchia, rep)
    eng_j = dgp_tpu.models.compiled.CompiledDGP(model.all_layer, block)
    eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(model.all_layer)), block,
                        device='cpu')
    return eng_j, eng_t


# ----------------------------------------------------------------------
# 4. the exact draws of the Hetero mean
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rep", [False, True])
def test_post_het_matches_jax(rep):
    eng_j, eng_t = _engines("Hetero", rep=rep)
    lat_j, par_j = eng_j.get_state()
    lat_t, par_t = eng_t.get_state()
    n = lat_t[1].shape[0]
    key = jax.random.PRNGKey(7)
    normals = np.asarray(jax.random.normal(key, (n, 2), jnp.float64))
    p = par_j[1][0]
    Xn = eng_j._node_input(1, 0, lat_j)
    v = p['scale'] * dgp_tpu.ops.kernels.k_matrix(Xn, p['length'], p['nugget'], 'sexp')
    y = eng_j.y_lik[0][:, 0]
    if rep:
        ref = eng_j._post_het(v, jnp.exp(lat_j[1][eng_j.rep][:, 1]), y, key, eng_j.rep)
    else:
        ref = eng_j._post_het(v, jnp.exp(lat_j[1][:, 1]), y, key, None)
    Gamma, y_eff = eng_t._het_site_noise(lat_t[1][:, 1], eng_t.y_lik[0][:, 0], rep)
    out = eng_t._post_het(_t(np.asarray(v)), Gamma, y_eff, None, normals=_t(normals))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)
    assert (len(y) > n) == rep


@pytest.mark.parametrize("rep", [False, True])
def test_post_het_vecch_matches_jax(rep):
    eng_j, eng_t = _engines("Hetero", vecchia=True, rep=rep)
    lat_j, par_j = eng_j.get_state()
    lat_t, par_t = eng_t.get_state()
    ns_j, ns_t = eng_j.get_nn_state()[1][0], eng_t.get_nn_state()[1][0]
    np.testing.assert_array_equal(ns_t['impNN'].numpy(), np.asarray(ns_j['impNN']))
    n = lat_t[1].shape[0]
    key = jax.random.PRNGKey(8)
    normals = np.asarray(jax.random.normal(key, (n,), jnp.float64))
    Gamma, y_eff = eng_t._het_site_noise(lat_t[1][:, 1], eng_t.y_lik[0][:, 0], rep)
    o = np.asarray(ns_j['ord'])
    p = par_j[1][0]
    Xn = np.asarray(eng_j._node_input(1, 0, lat_j))
    ref = jcore.post_het_vecch(key, jnp.asarray(Xn[o]), ns_j['impNN'],
                               jnp.asarray(Gamma.numpy()[o]), jnp.asarray(y_eff.numpy()[o]),
                               p['scale'], p['length'], p['nugget'], 'sexp')
    pt = par_t[1][0]
    out = tcore.post_het_vecch(None, _t(Xn[o]), ns_t['impNN'], Gamma[o], y_eff[o],
                               pt['scale'], pt['length'], pt['nugget'], 'sexp',
                               normals=_t(normals))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-12)


def test_post_het_vecch_matches_dense_posterior():
    """With full conditioning sets the stacked-Vecchia sampler is exact: its
    draws reproduce the closed-form Gaussian posterior N((S^-1+G^-1)^-1
    G^-1 y, (S^-1+G^-1)^-1), S = scale*corr (tests/test_vecchia.py:262)."""
    rs = np.random.RandomState(10)
    n = 12
    X = rs.uniform(size=(n, 1))
    scale, length = 1.4, np.array([0.4])
    Gamma = 0.05 + 0.1 * rs.uniform(size=n)
    y = np.sin(5 * X[:, 0]) + np.sqrt(Gamma) * rs.normal(size=n)
    impNN = _t(tnn.get_pred_nn(X, X, n, device='cpu')[:, 1:])
    gen = torch.Generator().manual_seed(3)
    draws = np.stack([tcore.post_het_vecch(gen, _t(X), impNN, _t(Gamma), _t(y), scale,
                                           _t(length), 1e-6, 'sexp').numpy()
                      for _ in range(4000)])
    S = scale * tkops.k_cross(_t(X), _t(X), _t(length), 'sexp').numpy() + 1e-10 * np.eye(n)
    P = np.linalg.inv(np.linalg.inv(S) + np.diag(1.0 / Gamma))
    mu = P @ (y / Gamma)
    mc_tol = float(4 * np.sqrt(np.max(np.diag(P)) / 4000) + 0.02)
    np.testing.assert_allclose(draws.mean(0), mu, atol=mc_tol)
    np.testing.assert_allclose(np.cov(draws.T), P, atol=0.05)


def test_ord_nn_pointer_matches_jax():
    rs = np.random.RandomState(11)
    X = rs.uniform(size=(70, 2))
    ordv = rs.permutation(70)
    nodes = []
    for pkg in (dgp_tpu, dgp_tpu_torch):
        node = pkg.kernel(length=np.array([0.3, 0.6]))
        node.input, node.m = X, 9
        kw = {'device': 'cpu'} if pkg is dgp_tpu_torch else {}
        node.ord_nn(ord=ordv.copy(), pointer=True, **kw)
        nodes.append(node)
    assert nodes[1].imp_NNarray.shape == (70, 8)
    np.testing.assert_array_equal(nodes[1].imp_NNarray, np.asarray(nodes[0].imp_NNarray))
    np.testing.assert_array_equal(nodes[1].NNarray, np.asarray(nodes[0].NNarray))
    plain = dgp_tpu_torch.kernel(length=np.array([0.3, 0.6]))
    plain.input, plain.m = X, 9
    plain.ord_nn(ord=ordv.copy(), device='cpu')
    assert plain.imp_NNarray is None


# ----------------------------------------------------------------------
# 5. latent initialisers
# ----------------------------------------------------------------------
def _init_models(family, rep):
    """Uninitialised dgp objects of both packages on the same data."""
    X, Y, layers = _family_data(family, rep, seed=3)
    out = []
    for pkg in (dgp_tpu, dgp_tpu_torch):
        m = pkg.dgp.__new__(pkg.dgp)
        X0, idx = np.unique(X, return_inverse=True, axis=0)
        m.X, m.indices = (X0, idx.flatten()) if rep else (X, None)
        m.n_data, m.vecch, m.m, m.ord_fun = len(m.X), False, 8, None
        m.all_layer = layers(pkg)
        m.n_layer = 3
        m.Y = Y
        if pkg is dgp_tpu_torch:
            m.device = torch.device('cpu')
        final = m.all_layer[-1][0]
        if family.startswith("Categorical"):
            m.Y = np.unique(Y, return_inverse=True)[1].reshape(-1, 1)
            final.num_classes = 2 if family == "Categorical" else 3
        out.append(m)
    return out


@pytest.mark.parametrize("rep", [False, True])
@pytest.mark.parametrize("family", ["Poisson", "NegBin", "ZIP", "ZINB", "Categorical",
                                    "Categorical3"])
def test_count_and_class_initialisers_match_jax(family, rep):
    mj, mt = _init_models(family, rep)
    In = mt.X
    ref = mj._init_layer_output(1, In)
    out = mt._init_layer_output(1, In)
    assert out.shape == (mt.n_data, len(mt.all_layer[1]))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("rep", [False, True])
def test_hetero_initialiser_matches_jax(rep):
    """Two trained pilot gps ('ref' prior) and their LOO lie between the
    data and the initial latents: 1e-5."""
    mj, mt = _init_models("Hetero", rep)
    res = []
    for m in (mj, mt):
        np.random.seed(21)
        res.append(m._init_layer_output(1, m.X))
    assert res[1].shape == (mt.n_data, 2)
    np.testing.assert_allclose(res[1], res[0], rtol=1e-5, atol=1e-8)


def test_kernel_pca_matches_sklearn():
    from sklearn.decomposition import KernelPCA
    from dgp_tpu_torch.models.dgp import _kernel_pca
    rs = np.random.RandomState(6)
    X = rs.randn(80, 5)
    ref = KernelPCA(n_components=2, kernel='sigmoid').fit_transform(X)
    out = _kernel_pca(X, 2, large=False)
    sign = np.sign(np.sum(out * ref, axis=0))
    np.testing.assert_allclose(out * sign, ref, rtol=1e-8, atol=1e-10)
    # the Nystrom variant, on the same landmarks as the JAX package's
    np.random.seed(1)
    big = _kernel_pca(X, 2, large=True)
    np.random.seed(1)
    np.testing.assert_allclose(big, dgp_tpu.utils.NystromKPCA(2).fit_transform(X),
                               rtol=1e-12)
    # a narrowing layer in a model: 3 inputs -> 2 nodes
    dgp_tpu_torch.nb_seed(0)
    k = lambda **kw: dgp_tpu_torch.kernel(length=np.array([1.0]), **kw)
    m = dgp_tpu_torch.dgp(rs.rand(30, 3), rs.rand(30, 1),
                          dgp_tpu_torch.combine([k(), k(), k()], [k(), k()],
                                                [k(scale_est=True)]), device='cpu')
    assert m.all_layer[2][0].input.shape == (30, 2)


def test_label_encoding_and_integer_targets():
    """Labels are encoded in sorted order, `num_classes` and the default
    link follow from them, and integer targets stay integer."""
    X, Y, layers = _family_data("Categorical3", False)
    dgp_tpu_torch.nb_seed(0)
    m = dgp_tpu_torch.dgp(X, Y, layers(dgp_tpu_torch), device='cpu')
    lik = m.all_layer[-1][0]
    assert list(lik.class_encoder.classes_) == [3, 7, 9]
    assert lik.num_classes == 3 and lik.link == 'softmax'
    assert np.issubdtype(m.Y.dtype, np.integer)
    np.testing.assert_array_equal(lik.class_encoder.transform(np.array([9, 3])), [2, 0])
    with pytest.raises(ValueError):
        lik.class_encoder.transform(np.array([4]))
    # the estimated scales of the last hidden layer are back at their values
    assert all(float(nd.scale[0]) == 1.0 for nd in m.all_layer[1])
    with pytest.raises(Exception, match="GP node"):
        dgp_tpu_torch.dgp(X, Y, dgp_tpu_torch.combine(
            [_k(dgp_tpu_torch, 'sexp')], [dgp_tpu_torch.Categorical()]), device='cpu')


# ----------------------------------------------------------------------
# 6. the engine on carried states
# ----------------------------------------------------------------------
def _cands(lat, K, seed):
    rs = np.random.RandomState(seed)
    return np.asarray(lat)[None] + 0.2 * rs.normal(size=(K,) + tuple(lat.shape))


@pytest.mark.parametrize("vecchia", [False, True])
@pytest.mark.parametrize("family", FAMILIES + ("Categorical", "Categorical3"))
def test_engine_logliks_match_jax(family, vecchia):
    """`_lik_loglik` (one state and a batch of candidates), `_upper_loglik`
    of both hidden layers, and the node-wise target of every node of the
    last hidden layer."""
    rep = family in ("Poisson", "Hetero", "ZINB")
    eng_j, eng_t = _engines(family, vecchia, rep)
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state() if vecchia else eng_j._empty_nn()
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    assert par_t[-1] == (None,) and eng_t.spec[-1][0].kind == 'likelihood'
    lik_j = jax.jit(lambda lat: eng_j._lik_loglik(0, (lat_j[0], lat)))
    np.testing.assert_allclose(float(eng_t._lik_loglik(0, lat_t)), float(lik_j(lat_j[1])),
                               rtol=1e-9)
    cands = _cands(lat_j[1], 4, 1)
    np.testing.assert_allclose(eng_t._lik_loglik(0, (lat_t[0], _t(cands))).numpy(),
                               [float(lik_j(jnp.asarray(c))) for c in cands], rtol=1e-9)
    for l in (0, 1):
        up_j = jax.jit(lambda lat, l=l: eng_j._upper_loglik(
            l, lat_j[:l] + (lat,) + lat_j[l + 1:], par_j, nn_j))
        cands = _cands(lat_j[l], 3, 2 + l)
        out = eng_t._upper_loglik(l, lat_t[:l] + (_t(cands),) + lat_t[l + 1:], par_t, nn_t)
        np.testing.assert_allclose(out.numpy(), [float(up_j(jnp.asarray(c))) for c in cands],
                                   rtol=1e-9)
    for k in range(lat_t[1].shape[1]):
        F = _cands(lat_j[1][:, k], 3, 5 + k)
        out = eng_t._nodewise_loglik(1, k, [0], _t(F), lat_t, par_t, nn_t)
        ref = [float(lik_j(lat_j[1].at[:, k].set(jnp.asarray(f)))) for f in F]
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize("family", ["Poisson", "NegBin"])
def test_angle_plan_with_likelihood_matches_jax(family):
    """The angle evaluator of the layer under a likelihood-only layer has no
    GP node (no K2 call) and evaluates the likelihood on all candidates in
    one call; under it, the layer below goes through the angle views."""
    eng_j, eng_t = _engines(family, vecchia=True, rep=family == "Poisson")
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state()
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    shares = _Shares(eng_t, nn_t)
    shares.sync(lat_t, par_t)
    ang = np.concatenate([[0.0], np.random.RandomState(2).uniform(0, 2 * np.pi, 8)])
    for l in (0, 1):
        assert eng_t._angle_applicable(l)
        nu = 0.5 * np.random.RandomState(1).normal(size=tuple(lat_t[l].shape))
        plan = eng_t._build_angle_plan(l, lat_t, par_t, shares.items[0], None, 1)
        assert len(plan['nodes']) == (lat_t[1].shape[1] if l == 0 else 0)
        assert plan['lik'] == ([] if l == 0 else [0])
        A = [nd['A0'] for nd in plan['nodes']]
        B = [eng_t._gather_latent_view(nd, _t(nu)) for nd in plan['nodes']]
        ll = eng_t._plan_ll([plan], l, lat_t, _t(nu), [A], [B], shares)
        f = np.asarray(lat_j[l])
        up_j = jax.jit(lambda lat, l=l: eng_j._upper_loglik(
            l, lat_j[:l] + (lat,) + lat_j[l + 1:], par_j, nn_j))
        ref = [float(up_j(jnp.asarray(np.cos(a) * f + np.sin(a) * nu))) for a in ang]
        np.testing.assert_allclose(ll(np.cos(ang).tolist(), np.sin(ang).tolist()).numpy(),
                                   ref, rtol=1e-9)


def test_exact_layer_is_nodewise_and_draws_exactly():
    """The layer under a Hetero node goes node by node even with
    block=True: its mean comes from the exact draw (the Vecchia one when
    the node carries its neighbour sets), its log-variance from ESS."""
    for vecchia, path in ((False, 'dense'), (True, 'vecchia')):
        _, eng_t = _engines("Hetero", vecchia, rep=True)
        assert eng_t.block and eng_t._layer_is_exact(1) and not eng_t._layer_is_exact(0)
        lat, par = eng_t.get_state()
        assert eng_t._build_angle_plan(1, lat, par,
                                       _Shares(eng_t, eng_t.get_nn_state()).items[0],
                                       None, 1) is None
        gen = torch.Generator().manual_seed(0)
        new, _ = eng_t.sample((lat, par), gen, torch.Generator().manual_seed(1), burnin=2)
        assert eng_t.exact_draws[path] == 3 and sum(eng_t.exact_draws.values()) == 3
        assert all(bool(torch.isfinite(a).all()) for a in new)
        assert not torch.equal(new[1][:, 0], lat[1][:, 0])
        assert not torch.equal(new[1][:, 1], lat[1][:, 1])


@pytest.mark.parametrize("family,vecchia", [("Poisson", False), ("Hetero", True)])
def test_m_step_under_likelihood_matches_jax(family, vecchia, monkeypatch):
    """One M-step of every GP node of a model with a likelihood node (the
    likelihood has no parameters): rtol 1e-6, as tests/test_torch_train.py
    holds the GP-only M-step."""
    from dgp_tpu.ops import pallas_vecchia as pv
    eng_j, eng_t = _engines(family, vecchia, rep=True)
    monkeypatch.setattr(pv, "use_pallas", lambda *a: True)
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state() if vecchia else eng_j._empty_nn()
    new_j = jax.jit(lambda lat, par, nn: eng_j._m_step(
        lat, par, nn, eng_j._chunk_static(nn)))(lat_j, par_j, nn_j)
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    new_t = eng_t._m_step(lat_t, par_t, nn_t)
    assert new_t[-1] == (None,) and new_j[-1] == (None,)
    flat_t = [v for layer in new_t for p in layer if p is not None
              for v in (p['length'], p['nugget'], p['scale'])]
    for pj, pt in zip(jax.tree_util.tree_leaves(new_j), flat_t):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    assert float(new_t[1][0]['scale']) != float(par_t[1][0]['scale'])
    assert len(eng_t._para_vector(new_t)) == len(flat_t) // 3


def _jax_ess_uniforms(k_ess, K):
    """The uniforms dgp_tpu.ess.ess_update draws from ``k_ess``, in the
    order the port's `ess_update` asks for them: (u0, theta0 / 2 pi) first,
    then K per round of candidates."""
    k_u, k_theta, k_loop = jax.random.split(k_ess, 3)
    state = {"key": k_loop, "first": True}

    def uniform(k):
        if state["first"]:
            state["first"] = False
            assert k == 2
            return [float(jax.random.uniform(k_u, dtype=jnp.float64)),
                    float(jax.random.uniform(k_theta, dtype=jnp.float64))]
        assert k == K
        state["key"], sub = jax.random.split(state["key"])
        return np.asarray(jax.random.uniform(sub, (K,), dtype=jnp.float64)).tolist()
    return uniform


def test_sem_iteration_hetero_vecchia_matches_jax_on_shared_draws(monkeypatch):
    """One whole SEM iteration of the Hetero Vecchia model (n = 300, m = 10)
    on a state carried over from dgp_tpu: the I-step (two sweeps: block ESS
    of layer 1 through the angle views, the exact draw of the Hetero mean
    through `post_het_vecch`, ESS of the log-variance node) and the M-step
    of the three GP nodes, against the JAX engine's `_i_step` and `_m_step`.
    The port is fed the normals and uniforms that the JAX engine's key tree
    yields, so both make the same draws and accept the same angles: latents
    at rtol 1e-7 (the worst of the 900 values differs by 1.3e-8 after two
    exact draws, each held to 1e-8 alone), hyper-parameters at 1e-6, as the
    M-step alone."""
    from dgp_tpu import config as jconfig
    from dgp_tpu_torch import config as tconfig
    from dgp_tpu_torch.models import compiled as tcompiled
    n, burnin = 300, 1
    rs = np.random.RandomState(11)
    X = np.sort(rs.rand(n, 1) * 2 - 1, axis=0)
    Y = np.sin(5 * X) + 0.1 * np.exp(0.8 * X) * rs.randn(n, 1)

    def layers(pkg):
        k = lambda length, **kw: pkg.kernel(length=np.array([length]), name='sexp',
                                            nugget=1e-4, **kw)
        return pkg.combine([k(0.5)], [k(0.2, scale_est=True, connect=np.arange(1))
                                      for _ in range(2)], [pkg.Hetero()])
    dgp_tpu.nb_seed(5)
    sample = jimp.imputer.sample
    jimp.imputer.sample = lambda self, burnin=0: None
    try:
        mj = dgp_tpu.dgp(X, Y, layers(dgp_tpu), vecchia=True, m=10)
    finally:
        jimp.imputer.sample = sample
    eng_j = dgp_tpu.models.compiled.CompiledDGP(mj.all_layer, True)
    eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(mj.all_layer)), True, device='cpu')
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state()
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    K = jconfig.ess_spec(n)
    assert K == tconfig.ess_spec(n) and K > 1
    assert eng_t._layer_is_exact(1) and eng_t._angle_applicable(0)

    key = jax.random.PRNGKey(3)
    new_lat_j = jax.jit(lambda lat, par, nn: eng_j._i_step(
        lat, par, nn, key, burnin, eng_j._chunk_static(nn)))(lat_j, par_j, nn_j)
    new_par_j = jax.jit(lambda lat, par, nn: eng_j._m_step(
        lat, par, nn, eng_j._chunk_static(nn)))(new_lat_j, par_j, nn_j)

    # the draws of the JAX engine's key tree (`_i_step`, `_sweep`,
    # `_ess_block_layer`, `_ess_nodewise_layer`), in the port's order
    S = burnin + 1
    key1, k_pre = jax.random.split(key)
    normals = [jax.random.normal(jax.random.split(k_pre, 1)[0], (S, n), jnp.float64)]
    ess_keys = []
    for k_sweep in jax.random.split(key1, S):
        k_l0, k_l1 = jax.random.split(k_sweep, 2)
        ess_keys.append(jax.random.split(k_l0)[1])
        k_mean, k_logvar = jax.random.split(k_l1, 2)
        normals.append(jax.random.normal(k_mean, (n,), jnp.float64))
        k_nu, k_ess = jax.random.split(k_logvar)
        normals.append(jax.random.normal(k_nu, (1, n), jnp.float64))
        ess_keys.append(k_ess)
    normals, ess_keys = iter(normals), iter(ess_keys)

    def randn(shape, *, generator=None, dtype=None, device=None):
        out = _t(np.array(next(normals)))
        assert tuple(out.shape) == tuple(shape) and dtype == torch.float64
        return out

    real_ess = tcompiled.ess_update

    def ess_update(gen, f, nu, log_lik, **kw):
        return real_ess(gen, f, nu, log_lik,
                        uniform=_jax_ess_uniforms(next(ess_keys), K), **kw)
    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(tcompiled, "ess_update", ess_update)
    new_lat_t = eng_t._i_step(lat_t, par_t, nn_t, (None, None), burnin)
    monkeypatch.undo()
    assert next(normals, None) is None and next(ess_keys, None) is None
    assert eng_t.exact_draws == {'dense': 0, 'vecchia': S}
    for a, b, old in zip(new_lat_t, new_lat_j, lat_t):
        assert not torch.equal(a, old)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-11)
    new_par_t = eng_t._m_step(new_lat_t, par_t, nn_t)
    flat_t = [v for layer in new_par_t for p in layer if p is not None
              for v in (p['length'], p['nugget'], p['scale'])]
    for pj, pt in zip(jax.tree_util.tree_leaves(new_par_j), flat_t):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    assert float(new_par_t[1][1]['scale']) != float(par_t[1][1]['scale'])


# ----------------------------------------------------------------------
# 7. the samplers leave their target unchanged
# ----------------------------------------------------------------------
def _chain(model, n_iter, burn):
    eng = model.imp._engine()
    state = eng.get_state()
    gen, host = torch.Generator().manual_seed(42), torch.Generator().manual_seed(43)
    out = []
    for i in range(n_iter):
        state = eng.sample(state, gen, host)
        if i >= burn:
            out.append(state[0][0].numpy().copy())
    return np.stack(out)


def test_ess_with_poisson_term_is_stationary():
    """f ~ N(0, S), y ~ Poisson(exp(f)), replicated: the chain's moments
    against self-normalised importance sampling from the prior."""
    rs = np.random.RandomState(0)
    n = 5
    X = np.linspace(0, 1, n)[:, None]
    Xr = np.concatenate([X, X])
    Y = rs.poisson(np.exp(1.0 + np.sin(4 * Xr[:, 0]))).astype(float)[:, None]
    dgp_tpu_torch.nb_seed(0)
    node = dgp_tpu_torch.kernel(length=np.array([0.4]), scale=1.5, nugget=1e-6)
    m = dgp_tpu_torch.dgp(Xr, Y, dgp_tpu_torch.combine([node], [dgp_tpu_torch.Poisson()]),
                          device='cpu')
    draws = _chain(m, 5000, 500)[:, :, 0]
    S = 1.5 * (np.exp(-((X - X.T) / 0.4) ** 2) + 1e-6 * np.eye(n))
    f = rs.normal(size=(400_000, n)) @ np.linalg.cholesky(S).T
    fr = np.concatenate([f, f], axis=1)
    logw = np.sum(Y[:, 0] * fr - np.exp(fr), axis=1)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mu = w @ f
    var = w @ (f - mu) ** 2
    np.testing.assert_allclose(draws.mean(0), mu, atol=0.05)
    np.testing.assert_allclose(draws.var(0), var, rtol=0.3, atol=0.01)


def test_hetero_gibbs_is_stationary():
    """Mean f ~ N(0, S1) drawn exactly, log-variance g ~ N(0, S2) by ESS, y ~
    N(f, exp(g)): against importance sampling of g from its prior with f
    integrated out, p(y | g) = N(0, S1 + diag(exp(g)))."""
    rs = np.random.RandomState(1)
    n = 5
    X = np.linspace(0, 1, n)[:, None]
    Y = (np.sin(4 * X[:, 0]) + 0.3 * rs.normal(size=n))[:, None]
    dgp_tpu_torch.nb_seed(1)
    k = lambda s: dgp_tpu_torch.kernel(length=np.array([0.4]), scale=s, nugget=1e-6)
    m = dgp_tpu_torch.dgp(X, Y, dgp_tpu_torch.combine([k(1.0), k(0.8)],
                                                      [dgp_tpu_torch.Hetero()]),
                          check_rep=False, device='cpu')
    eng = m.imp._engine()
    draws = _chain(m, 5000, 500)
    assert eng.exact_draws['dense'] >= 5000 and eng.exact_draws['vecchia'] == 0
    C = np.exp(-((X - X.T) / 0.4) ** 2) + 1e-6 * np.eye(n)
    S1, S2 = 1.0 * C, 0.8 * C
    g = rs.normal(size=(200_000, n)) @ np.linalg.cholesky(S2).T
    V = S1[None] + np.exp(g)[:, :, None] * np.eye(n)
    sol = np.linalg.solve(V, np.broadcast_to(Y, (len(g), n, 1)))[:, :, 0]
    logw = -0.5 * (np.linalg.slogdet(V)[1] + sol @ Y[:, 0])
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mu_g = w @ g
    mu_f = w @ (sol @ S1)                       # E[f | g, y] = S1 V^-1 y
    np.testing.assert_allclose(draws[:, :, 1].mean(0), mu_g, atol=0.08)
    np.testing.assert_allclose(draws[:, :, 0].mean(0), mu_f, atol=0.05)
    np.testing.assert_allclose(draws[:, :, 1].var(0), w @ (g - mu_g) ** 2, rtol=0.3)


# ----------------------------------------------------------------------
# 8. the emulator on carried imputations
# ----------------------------------------------------------------------
def _jax_emulator(family, vecchia, rep, N=2):
    """A dgp_tpu emulator over N imputations that differ in their latents
    (the model's own, perturbed), without drawing any."""
    model = _jax_model(family, vecchia, rep)
    sets = []
    for i in range(N):
        al = copy.deepcopy(model.all_layer)
        eng = dgp_tpu.models.compiled.CompiledDGP(al)
        lat, par = eng.get_state()
        rs = np.random.RandomState(30 + i)
        eng.set_state((tuple(a + 0.05 * rs.normal(size=a.shape) for a in lat), par))
        if not vecchia:
            jimp.imputer(al).key_stats()
        sets.append(al)
    emu = dgp_tpu.emulator.__new__(dgp_tpu.emulator)
    emu.all_layer, emu.n_layer, emu.vecch, emu.block = sets[0], 3, vecchia, True
    emu.all_layer_set = sets
    return emu


@pytest.mark.parametrize("family,vecchia", [
    ("Hetero", True), ("Poisson", False), ("NegBin", False), ("ZIP", True),
    ("ZINB", False), ("Categorical", False)])
def test_emulator_predict_and_nllik_match_jax(family, vecchia):
    rep = family in ("Poisson", "Hetero", "ZINB")
    emu_j = _jax_emulator(family, vecchia, rep)
    emu_t = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set], device='cpu')
    assert emu_t.all_layer[-1][0].name == emu_j.all_layer[-1][0].name
    z = np.linspace(0.02, 0.98, 25)[:, None]
    # variances near 0 are differences of O(1) moments: an absolute floor of
    # 1e-9 beside the relative bound
    tol = dict(rtol=1e-8, atol=1e-9)
    mu_j, var_j = emu_j.predict(z, m=15)
    mu_t, var_t = emu_t.predict(z, m=15)
    assert mu_t.shape == (25, 1)
    np.testing.assert_allclose(mu_t, mu_j, **tol)
    np.testing.assert_allclose(var_t, var_j, **tol)
    each_j = emu_j.predict(z, m=15, aggregation=False)
    each_t = emu_t.predict(z, m=15, aggregation=False)
    for a, b in zip(each_t, each_j):
        assert len(a) == len(b) == 2
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)
    # ascending inputs with a repeated row, which nllik collapses
    zt = np.concatenate([z[:12], z[11:]])
    rs = np.random.RandomState(9)
    if family == "Hetero":
        y = np.sin(5 * zt) + 0.1 * rs.normal(size=zt.shape)
    elif family == "Categorical":
        y = (rs.rand(*zt.shape) < 0.5).astype(float)
    else:
        y = rs.poisson(2.0, zt.shape).astype(float)
    nll_j, each_j = emu_j.nllik(zt, y, m=15)
    nll_t, each_t = emu_t.nllik(zt, y, m=15)
    np.testing.assert_allclose(each_t, each_j, **tol)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-8)


def test_nllik_pairs_targets_with_unsorted_inputs():
    """`nllik` scores each y at its own x whatever the order of the rows."""
    emu_j = _jax_emulator("Poisson", False, True)
    emu_t = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set], device='cpu')
    z = np.linspace(0.02, 0.98, 25)[:, None]
    y = np.random.RandomState(9).poisson(2.0, z.shape).astype(float)
    perm = np.random.RandomState(10).permutation(25)
    _, each = emu_t.nllik(z, y)
    _, each_p = emu_t.nllik(z[perm], y[perm])
    # another row order sums in another order inside the batched products
    np.testing.assert_allclose(each_p, each[perm], rtol=1e-9)
    with pytest.raises(Exception, match="single likelihood node"):
        dgp_tpu_torch.emulator.from_imputations(
            [[s[0], s[1]] for s in emu_t.all_layer_set], device='cpu').nllik(z, y)


# ----------------------------------------------------------------------
# 9. the slice as a whole
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["poisson-dense", "hetero-rep-dense", "hetero-vecchia",
                                  "categorical3-dense", "zinb-vecchia-nodewise"])
def test_slice_trains_and_predicts(case):
    """dgp -> train(N=10) -> estimate -> emulator(N=3) -> predict, nllik at a
    small size: finite values of the right shapes through the entry points."""
    family = {"poisson": "Poisson", "hetero": "Hetero", "categorical3": "Categorical3",
              "zinb": "ZINB"}[case.split("-")[0]]
    vecchia = "vecchia" in case
    X, Y, layers = _family_data(family, rep="rep" in case or family == "Poisson",
                                n_sites=40 if vecchia else 24, seed=4)
    dgp_tpu_torch.nb_seed(2)
    m = dgp_tpu_torch.dgp(X, Y, layers(dgp_tpu_torch), vecchia=vecchia, m=8,
                          block="nodewise" not in case, device='cpu')
    m.train(N=10, disable=True)
    assert m.N == 10
    gp_nodes = [nd for layer in m.all_layer for nd in layer if nd.type == 'gp']
    assert all(nd.para_path.shape[0] == 11 and np.isfinite(nd.para_path).all()
               for nd in gp_nodes)
    lik = m.all_layer[-1][0]
    assert lik.input.shape == (len(Y), len(m.all_layer[1]))
    draws = m.imp._engine().exact_draws
    if family == "Hetero":
        assert draws['vecchia' if vecchia else 'dense'] > 0
        assert draws['dense' if vecchia else 'vecchia'] == 0
        assert (m.all_layer[1][0].imp_NNarray is not None) == vecchia
    else:
        assert not any(draws.values())
    est = m.estimate()
    assert est[-1][0].type == 'likelihood'
    emu = dgp_tpu_torch.emulator(est, N=3, device='cpu')
    z = np.linspace(0, 1, 30)[:, None]
    mu, var = emu.predict(z, m=20)
    width = 3 if family == "Categorical3" else 1
    assert mu.shape == (30, width) and var.shape == (30, width)
    assert np.isfinite(mu).all() and np.isfinite(var).all() and (var >= 0).all()
    if family == "Categorical3":
        np.testing.assert_allclose(mu.sum(axis=1), 1.0, rtol=1e-9)
        yz = np.full((30, 1), 1)
    else:
        yz = Y[:30]
    nll, each = emu.nllik(z, yz, m=20)
    assert each.shape == (30,) and np.isfinite(each).all() and np.isfinite(nll)


def test_poisson_nllik_within_jax_seed_spread():
    """The random streams differ between the packages, so a trained model's
    test nllik agrees only in distribution: two-sided, every seed between
    the JAX package's best seed less two standard deviations of its seed
    spread and its worst plus two (tests/torch_lik_spread.json, written by
    tools/make_torch_lik_params.py, whose `poisson_small` protocol runs here
    on the port)."""
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    import make_torch_lik_params as proto
    stored = json.loads((root / "tests" / "torch_lik_spread.json").read_text())
    spread = np.asarray([r["test_nllik"] for r in stored["poisson_small"]["jax"]])
    assert len(spread) == 10
    lo, hi = spread.min() - 2 * spread.std(), spread.max() + 2 * spread.std()
    nll = [proto.run_poisson_small(dgp_tpu_torch, seed, device='cpu')["test_nllik"]
           for seed in range(4)]
    assert all(np.isfinite(nll)), nll
    assert lo <= min(nll) and max(nll) <= hi, (nll, lo, hi)


@pytest.mark.parametrize("link", ["probit", "logit"])
def test_binary_dgp_end_to_end(link):
    dgp_tpu_torch.nb_seed(3)
    rs = np.random.RandomState(3)
    n = 80
    X = np.sort(rs.rand(n, 1), axis=0)
    y = (rs.rand(n, 1) < norm.cdf(2.5 * np.sin(6.0 * X))).astype(int)
    lay1 = [dgp_tpu_torch.kernel(length=np.array([0.3]), name='matern2.5', scale_est=True)]
    m = dgp_tpu_torch.dgp(X, y, dgp_tpu_torch.combine(
        lay1, [dgp_tpu_torch.Categorical(num_classes=2, link=link)]), device='cpu')
    m.train(N=30, disable=True)
    emu = dgp_tpu_torch.emulator(m.estimate(), N=5, device='cpu')
    z = np.linspace(0.02, 0.98, 60)[:, None]
    prob = np.asarray(emu.predict(z)[0]).reshape(-1)
    assert prob.shape == (60,)
    assert np.all((prob >= 0) & (prob <= 1))
    truth = (norm.cdf(2.5 * np.sin(6.0 * z.flatten())) > 0.5).astype(int)
    acc = np.mean((prob > 0.5).astype(int) == truth)
    assert acc >= 0.8, acc
