"""The single-GP layer of dgp_tpu_torch against dgp_tpu, on the CPU in
float64, from the same numpy-seeded inputs:

1. `gp_core` (the objective with profiled scale, replicates and priors,
   its autograd gradient against `jax.grad`, the fixed-parameter
   log-likelihood, the prediction statistics, dense and linked prediction,
   the closed-form LOO) and `design.mice_var`;
2. the `gp` class end to end, dense and Vecchia, the JAX gp carried
   across before training (`interop.gp_from_numpy`, so both share the data
   and the Vecchia ordering): trained hyper-parameters, predictions, LOO,
   the Vecchia log-likelihood and the design criteria's picks;
3. the entry points that are not ported raise, and with no card and no
   ``device`` the gp raises naming device='cpu'.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
from dgp_tpu import design as jdesign
from dgp_tpu import gp_core as jcore
import dgp_tpu_torch
from dgp_tpu_torch import design as tdesign
from dgp_tpu_torch import gp_core as tcore
from dgp_tpu_torch.interop import gp_from_numpy

torch.set_num_threads(1)

PRIORS = ('ga', 'inv_ga', 'ref', None)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _coef(prior, p):
    """The adjusted coefficients a node stores for ``prior`` (and 'ref''s b
    for an input of width p and n = 20 points)."""
    if prior == 'ga':
        return np.array([0.6, 0.3])
    if prior == 'inv_ga':
        return np.array([2.6, 0.3])
    if prior == 'ref':
        return np.array([0.2, (0.2 + p) / 20 ** (1 / p)])
    return None


def _case(rep, n_length, seed=0):
    """Inputs of one node: X (n, 2) with three replicated rows collapsed
    when ``rep``, y, and the replicate weights and residual sum."""
    rs = np.random.RandomState(seed)
    X = rs.rand(20, 2)
    y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * rs.randn(20)
    w_diag = sum_res = None
    if rep:
        w_diag = 1.0 / rs.randint(1, 4, size=20)
        sum_res = 0.37
    length = np.array([0.4]) if n_length == 1 else np.array([0.4, 0.7])
    return X, y, w_diag, sum_res, length


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("rep", (False, True))
@pytest.mark.parametrize("scale_est,nugget_est,n_length",
                         ((True, True, 1), (False, True, 2), (True, False, 2)))
def test_neg_log_lik_and_grad(prior, rep, scale_est, nugget_est, n_length):
    """Value at rtol 1e-9, autograd gradient against jax.grad at 1e-7,
    the profiled scale at 1e-9."""
    X, y, w_diag, sum_res, length = _case(rep, n_length)
    lt = np.log(np.concatenate([length, [0.05]]) if nugget_est else length)
    coef = _coef(prior, 2)
    cl_j = (jcore.compute_cl(jnp.asarray(X), 20, n_length, False)
            if prior == 'ref' else None)
    kw = dict(name='sexp', n_length=n_length, scale_est=scale_est,
              nugget_est=nugget_est, fixed_scale=1.3, fixed_nugget=0.02,
              prior_name=prior, n_orig=26.0 if rep else None)
    (v_j, s_j), g_j = jax.value_and_grad(
        lambda t: jcore.neg_log_lik(
            t, jnp.asarray(X), jnp.asarray(y),
            prior_coef=None if coef is None else jnp.asarray(coef),
            w_diag=None if w_diag is None else jnp.asarray(w_diag),
            sum_residual=sum_res, cl=cl_j, **kw), has_aux=True)(jnp.asarray(lt))
    cl_t = tcore.compute_cl(_t(X), 20, n_length, False) if prior == 'ref' else None
    if prior == 'ref':
        np.testing.assert_allclose(cl_t.numpy(), np.asarray(cl_j), rtol=1e-12)
    v_t, g_t, s_t = tcore.neg_log_lik_and_grad(
        _t(lt), _t(X), _t(y), prior_coef=None if coef is None else _t(coef),
        w_diag=None if w_diag is None else _t(w_diag), sum_residual=sum_res,
        cl=cl_t, **kw)
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-9)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-9)


@pytest.mark.parametrize("name", ("sexp", "matern2.5"))
@pytest.mark.parametrize("rep", (False, True))
def test_fixed_loglik_stats_predict_loo(name, rep):
    """log_lik_fixed (with the 'ref' term, and for a batch of candidate
    inputs), compute_stats, gp_predict and loo at rtol 1e-9."""
    X, y, w_diag, _, length = _case(rep, 2, seed=1)
    wj = None if w_diag is None else jnp.asarray(w_diag)
    wt = None if w_diag is None else _t(w_diag)
    coef = _coef('ref', 2)
    for ref in (None, coef):
        ll_j = jcore.log_lik_fixed(jnp.asarray(X), jnp.asarray(y), jnp.asarray(length),
                                   1.7, 0.03, name=name, w_diag=wj,
                                   ref_prior_coef=None if ref is None else jnp.asarray(ref),
                                   n_length=2)
        ll_t = tcore.log_lik_fixed(_t(X), _t(y), _t(length), 1.7, 0.03, name=name,
                                   w_diag=wt, ref_prior_coef=None if ref is None else _t(ref),
                                   n_length=2)
        np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-9)
    cands = X[None] + 0.05 * np.random.RandomState(2).randn(3, 20, 2)
    ll_b = tcore.log_lik_fixed(_t(cands), _t(y), _t(length), 1.7, 0.03, name=name,
                               w_diag=wt, ref_prior_coef=_t(coef), n_length=2)
    np.testing.assert_allclose(
        ll_b.numpy(), [float(jcore.log_lik_fixed(
            jnp.asarray(c), jnp.asarray(y), jnp.asarray(length), 1.7, 0.03, name=name,
            w_diag=wj, ref_prior_coef=jnp.asarray(coef), n_length=2)) for c in cands],
        rtol=1e-9)
    R_j, Ry_j = jcore.compute_stats(jnp.asarray(X), jnp.asarray(y), jnp.asarray(length),
                                    0.03, name=name, w_diag=wj)
    R_t, Ry_t = tcore.compute_stats(_t(X), _t(y), _t(length), 0.03, name=name, w_diag=wt)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Ry_t.numpy(), np.asarray(Ry_j), rtol=1e-9, atol=1e-11)
    x = np.random.RandomState(3).rand(15, 2)
    for a, b in zip(tcore.gp_predict(_t(x), _t(X), R_t, Ry_t, 1.7, _t(length), 0.03,
                                     name=name),
                    jcore.gp_predict(jnp.asarray(x), jnp.asarray(X), R_j, Ry_j, 1.7,
                                     jnp.asarray(length), 0.03, name=name)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)
    for a, b in zip(tcore.loo(_t(y), R_t, Ry_t, 1.7),
                    jcore.loo(jnp.asarray(y), R_j, Ry_j, 1.7)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


@pytest.mark.parametrize("name", ("sexp", "matern2.5"))
@pytest.mark.parametrize("with_z", (False, True))
def test_linkgp_predict(name, with_z):
    """Linked prediction of 12 Gaussian queries at rtol 1e-9, with and
    without a deterministic global input."""
    rs = np.random.RandomState(4)
    W, Z = rs.rand(18, 2), rs.rand(18, 1)
    y = np.cos(3 * W[:, 0]) + W[:, 1] + Z[:, 0]
    Xfull = np.concatenate([W, Z], axis=1) if with_z else W
    length = np.array([0.5, 0.8, 0.6]) if with_z else np.array([0.5, 0.8])
    R_j, Ry_j = jcore.compute_stats(jnp.asarray(Xfull), jnp.asarray(y),
                                    jnp.asarray(length), 0.01, name=name)
    m, v, z = rs.rand(12, 2), 0.05 * rs.rand(12, 2), rs.rand(12, 1)
    v[3] = 0.0                                  # a deterministic query
    ref = jcore.linkgp_predict(jnp.asarray(m), jnp.asarray(v),
                               jnp.asarray(z) if with_z else None, jnp.asarray(W),
                               jnp.asarray(Z) if with_z else None, R_j, Ry_j, 1.4,
                               jnp.asarray(length), 0.01, name=name)
    out = tcore.linkgp_predict(_t(m), _t(v), _t(z) if with_z else None, _t(W),
                               _t(Z) if with_z else None, _t(np.asarray(R_j)),
                               _t(np.asarray(Ry_j)), 1.4, _t(length), 0.01, name=name)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("connect", (None, [1]))
def test_mice_var(connect):
    rs = np.random.RandomState(5)
    x = rs.rand(40, 2)
    input_dim = [0] if connect else [0, 1]
    length = np.array([0.3, 0.4]) if connect else np.array([0.3])
    args = (x, x, input_dim, connect, 'sexp', length, np.array([1.2]), 1e-3, 0.5)
    np.testing.assert_allclose(tdesign.mice_var(*args, device='cpu'),
                               jdesign.mice_var(*args), rtol=1e-9)


# ----------------------------------------------------------------------
# 2. the gp class end to end
# ----------------------------------------------------------------------
def _gp_data(rep):
    rs = np.random.RandomState(6)
    X = rs.rand(80, 2)
    Y = np.sin(5 * X[:, :1]) * np.cos(3 * X[:, 1:]) + 0.05 * rs.randn(80, 1)
    if rep:
        X = np.vstack([X, X[:10]])
        Y = np.vstack([Y, Y[:10] + 0.04 * rs.randn(10, 1)])
    return X, Y


def _pair(vecchia, prior, rep, nugget_est=True):
    X, Y = _gp_data(rep)
    dgp_tpu.nb_seed(0)
    k = dgp_tpu.kernel(length=np.array([0.5]), nugget=1e-2, scale_est=True,
                       nugget_est=nugget_est, prior_name=prior,
                       bds=[0.01, 5.0] if prior == 'inv_ga' else None)
    gj = dgp_tpu.gp(X, Y, k, vecchia=vecchia, m=12)
    return gj, gp_from_numpy(gj, device='cpu')


def _params(g):
    return np.concatenate([g.kernel.scale, g.kernel.length, g.kernel.nugget])


@pytest.mark.parametrize("vecchia", (False, True))
@pytest.mark.parametrize("prior,rep,nugget_est",
                         (('ga', False, True), ('ref', True, True), (None, False, False),
                          ('inv_ga', True, True)))
def test_gp_end_to_end(vecchia, prior, rep, nugget_est):
    """From the same start, train() ends at the JAX package's
    hyper-parameters (rtol 1e-6; the Vecchia objective through K1's plain
    version against JAX's XLA autodiff); prediction, LOO and the Vecchia
    log-likelihood agree at rtol 1e-9 before training and 1e-8 after (each
    package at its own trained parameters); the design criteria pick the
    same candidate."""
    gj, gt = _pair(vecchia, prior, rep, nugget_est)
    z = np.random.RandomState(7).rand(30, 2)
    for stage, tol in (("initial", 1e-9), ("trained", 1e-8)):
        if stage == "trained":
            gj.train()
            gt.train()
            np.testing.assert_allclose(_params(gt), _params(gj), rtol=1e-6)
            np.testing.assert_allclose(gt.kernel.para_path, gj.kernel.para_path, rtol=1e-6)
        for a, b in zip(gt.predict(z, m=20), gj.predict(z, m=20)):
            np.testing.assert_allclose(a, b, rtol=tol, atol=1e-12)
        for a, b in zip(gt.loo(m=15), gj.loo(m=15)):
            np.testing.assert_allclose(a, b, rtol=tol, atol=1e-12)
        np.testing.assert_allclose(gt.kernel.log_likelihood_func(),
                                   gj.kernel.log_likelihood_func(), rtol=tol)
    for meth in ('ALM', 'MICE') + (() if rep else ('VIGF',)):
        assert gt.metric(z, method=meth, m=20)[0] == gj.metric(z, method=meth, m=20)[0], meth


@pytest.mark.parametrize("vecchia", (False, True))
def test_gp_constructor_and_modes(vecchia):
    """The port's own constructor wires the node as the JAX one does
    (replicates, 'ref' coefficients and cl, para_path), and to_vecchia /
    remove_vecchia switch the prediction path."""
    X, Y = _gp_data(True)
    kw = dict(length=np.array([0.5, 0.4]), nugget=1e-2, scale_est=True,
              nugget_est=True, prior_name='ref')
    gj = dgp_tpu.gp(X, Y, dgp_tpu.kernel(**kw), vecchia=vecchia, m=12)
    gt = dgp_tpu_torch.gp(X, Y, dgp_tpu_torch.kernel(**kw), vecchia=vecchia, m=12,
                          device='cpu')
    for key in ('prior_coef', 'cl', 'W_diag', 'sum_residual', 'rep', 'para_path', 'output'):
        np.testing.assert_allclose(getattr(gt.kernel, key), getattr(gj.kernel, key),
                                   rtol=1e-12)
    assert gt.kernel.D == gj.kernel.D and gt.kernel.target == 'gp'
    z = np.random.RandomState(8).rand(10, 2)
    if vecchia:
        gt.remove_vecchia()
        gj.remove_vecchia()
    else:
        gt.to_vecchia(m=10)
        gt.kernel.ord_nn(ord=np.arange(len(gt.X)))
        gj.to_vecchia(m=10)
        gj.kernel.ord_nn(ord=np.arange(len(gj.X)))
    for a, b in zip(gt.predict(z, m=15), gj.predict(z, m=15)):
        np.testing.assert_allclose(a, b, rtol=1e-9)


@pytest.mark.parametrize("vecchia", (False, True))
def test_gp_update_xy_and_export(vecchia):
    """update_xy with replicated new data (and reset to the initial
    hyper-parameters), the same numpy seed before each Vecchia re-ordering:
    the node's state and the predictions agree at rtol 1e-9; export gives
    a copy of the node."""
    gj, gt = _pair(vecchia, 'ref', False)
    X2, Y2 = _gp_data(True)
    X2, Y2 = X2[::2], Y2[::2] + 0.1
    for g in (gj, gt):
        g.kernel.length = g.kernel.length * 1.3
        np.random.seed(3)
        g.update_xy(X2, Y2, reset=True)
    for key in ('length', 'scale', 'nugget', 'cl', 'W_diag', 'sum_residual', 'output'):
        np.testing.assert_allclose(getattr(gt.kernel, key), getattr(gj.kernel, key),
                                   rtol=1e-12)
    z = np.random.RandomState(9).rand(12, 2)
    for a, b in zip(gt.predict(z, m=15), gj.predict(z, m=15)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    (node,) = gt.export()
    assert node is not gt.kernel
    np.testing.assert_array_equal(node.length, gt.kernel.length)


def test_gp_unported_and_device(monkeypatch):
    X, Y = _gp_data(False)
    g = dgp_tpu_torch.gp(X, Y, dgp_tpu_torch.kernel(length=np.array([0.5])), device='cpu')
    # O7: ppredict is an alias of predict, pmetric of metric
    for a, b in zip(g.ppredict(X, chunk_num=2), g.predict(X)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.pmetric(X, score_only=True, core_num=2),
                                  g.metric(X, score_only=True))
    assert g.kernel.nn_method == 'exact'
    # from APPROX_NN_N points on, a gp (dense too) constructs with the IVF
    # search as its node's method, as dgp_tpu's does
    from dgp_tpu_torch.models import gp as tgp
    monkeypatch.setattr(tgp, "APPROX_NN_N", len(X))
    g = dgp_tpu_torch.gp(X, Y, dgp_tpu_torch.kernel(length=np.array([0.5])), device='cpu')
    assert g.kernel.nn_method == 'approx'
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dgp_tpu_torch.gp(X, Y, dgp_tpu_torch.kernel(length=np.array([0.5])))
