"""The large-n path of dgp_tpu_torch (the IVF approximate neighbour search
and the n >= 50000 switch that chooses it) against dgp_tpu, on the CPU in
float64, from the same numpy-seeded inputs:

1. `vecchia.nn`: the k-means (cold and warm), the inverted lists at both
   capacities, the ordered search with and without the imputation sets,
   the prediction search and the cluster-restricted query, exactly equal to
   the JAX package's arrays (centroids within rtol 1e-12); a clustered
   input whose buckets overflow, so that the fallback pass (and past its
   capacity the stranded-row repair) runs; batching the buckets changes
   nothing; recall against the exact search in float64 and float32;
2. the engine's device refresh of approximate nodes: the reference layout,
   and on the same permutation the JAX package's device search;
3. the models: `gp` and `dgp` at the (lowered) threshold search with IVF,
   a Vecchia gp trains to the JAX package's parameters, a Vecchia DGP
   trains and its emulator's IVF predictions agree with the exact search's
   on the same imputations, and `interop` carries the search.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
from dgp_tpu.vecchia import nn as jnn
import dgp_tpu_torch
from dgp_tpu_torch.interop import gp_from_numpy
from dgp_tpu_torch.models import dgp as tdgp
from dgp_tpu_torch.models import gp as tgp
from dgp_tpu_torch.vecchia import nn as tnn

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _x(n, d, seed):
    return np.random.RandomState(seed).rand(n, d)


def _clustered(n, blob, seed):
    """Uniform points on the unit square with ``blob`` of them moved into
    one tight cluster (sd 1e-3), on rows that the k-means start does not
    take, so that the cluster stays one bucket and overflows its query
    capacity."""
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 2)
    K, _ = tnn._ivf_params(n)
    free = np.flatnonzero(np.arange(n) % (n // K) != 0)
    rows = rs.choice(free, blob, replace=False)
    X[rows] = 0.5 + 1e-3 * rs.randn(blob, 2)
    return X


@pytest.mark.parametrize("warm", (False, True))
def test_kmeans_matches_jax(warm):
    X = _x(2000, 2, 1)
    K, _ = tnn._ivf_params(len(X))
    cent0 = None
    if warm:
        cent0 = np.asarray(jnn._kmeans_fit(jnp.asarray(X), K, 1)[0]) + 0.01
    iters = tnn.KMEANS_WARM_ITERS if warm else tnn.KMEANS_ITERS
    cj, aj = jnn._kmeans_fit(jnp.asarray(X), K, iters,
                             None if cent0 is None else jnp.asarray(cent0))
    ct, at = tnn._kmeans_fit(_t(X), K, iters, cent0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("capacity", ("Lmax", "Lq"))
def test_buckets_match_jax(capacity):
    """Both capacities: the prediction lists (Lmax) and the self-query's
    (Lq), against both of the JAX package's builders; a clustered input,
    so that some lists overflow."""
    X = _clustered(2000, 150, 2)
    K, Lmax = tnn._ivf_params(len(X))
    L = Lmax if capacity == "Lmax" else tnn._lq(len(X), K)
    _, aj = jnn._kmeans_fit(jnp.asarray(X), K, 6)
    aj = np.asarray(aj)
    got = tnn._buckets(_t(aj), K, L).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnn._buckets_dev(jnp.asarray(aj), K, L)))
    np.testing.assert_array_equal(got, jnn._buckets_np(aj, K, L))
    assert (np.bincount(aj, minlength=K) > L).any()


@pytest.mark.parametrize("d", (1, 2, 5))
def test_approx_search_matches_jax(d):
    """nn(method='approx'), the imputation variant (self excluded, (n,
    m-1), nearest first, 0 padded) and get_pred_nn(method='approx')."""
    n, m = 1500, 10
    X = _x(n, d, 10 + d)
    Q = _x(300, d, 20 + d)
    np.testing.assert_array_equal(tnn.nn(X, m, method='approx', device='cpu'),
                                  jnn.nn(X, m, method='approx'))
    oj, ij = jnn.nn_approx_dev(jnp.asarray(X), m, impute=True)
    ot, it = tnn.nn_approx(_t(X), m, impute=True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert it.shape == (n, m - 1)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(
        tnn.get_pred_nn(Q, X, 15, method='approx', device='cpu'),
        jnn.get_pred_nn(Q, X, 15, method='approx'))


@pytest.mark.parametrize("blob", (150, 400))
def test_fallback_pass_matches_jax(blob):
    """A cluster larger than a bucket's query capacity: its overflow rows
    go through the per-query fallback pass; at 400 of 2000 points they
    exceed the pass's capacity too and the rows left over keep themselves.
    Every array equals the JAX package's."""
    n, m = 2000, 10
    X = _clustered(n, blob, 3)
    K, _ = tnn._ivf_params(n)
    _, assign = tnn._kmeans_fit(_t(X), K, tnn.KMEANS_ITERS)
    Bq = tnn._buckets(assign, K, tnn._lq(n, K)).numpy()
    uncovered = np.setdiff1d(np.arange(n), Bq[Bq >= 0])
    left = uncovered[tnn._fallback_cap(n):]
    assert len(uncovered) > 0 and (len(left) > 0) == (blob == 400)
    oj, ij = jnn.nn_approx_dev(jnp.asarray(X), m, impute=True)
    ot, it = tnn.nn_approx(_t(X), m, impute=True)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    ot = ot.numpy()
    assert (ot[left, 0] == left).all() and (ot[left, 1:] < 0).all()
    assert (ot[uncovered[:tnn._fallback_cap(n)][1:], 1] >= 0).all()


@pytest.mark.parametrize("batch", (1, 7, None))
def test_bucket_batching_changes_nothing(batch):
    """One bucket, seven or all of them at a time give the same arrays."""
    X = _clustered(2000, 150, 4)
    K, _ = tnn._ivf_params(len(X))
    want = tnn.nn_approx(_t(X), 12, impute=True, batch=K)
    got = tnn.nn_approx(_t(X), 12, impute=True, batch=batch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
def test_approx_recall(dtype):
    """IVF recovers almost all of the exact neighbour sets (n = 4096, as
    tests/test_vecchia.py::test_approx_nn_recall), ordered and for
    prediction; the exact sets in float64."""
    rs = np.random.RandomState(12)
    n, m = 4096, 10
    X = rs.normal(size=(n, 2))
    Q = rs.normal(size=(300, 2))
    exact = tnn.nn(X, m, device='cpu')
    approx = tnn.nn(X.astype(dtype), m, method='approx', device='cpu')
    hits = total = 0
    for i in range(0, n, 7):
        e = set(int(j) for j in exact[i] if j >= 0)
        hits += len(e & set(int(j) for j in approx[i] if j >= 0))
        total += len(e)
    assert hits / total > 0.95
    exact_p = tnn.get_pred_nn(Q, X, m, device='cpu')
    approx_p = tnn.get_pred_nn(Q.astype(dtype), X.astype(dtype), m, method='approx',
                               device='cpu')
    assert sum(len(set(e) & set(a)) for e, a in zip(exact_p, approx_p)) / exact_p.size > 0.95


@pytest.mark.parametrize("d", (1, 3))
def test_ivf_query_matches_jax(d):
    """The cluster-restricted prediction query on the JAX package's own
    index, -1 where a query has too few candidates."""
    X = _x(1500, d, 30 + d)
    Q = _x(400, d, 40 + d)
    cent, buckets = jnn._ivf_build(X, len(X))
    want = np.asarray(jnn._ivf_query(jnp.asarray(Q), jnp.asarray(X), cent, buckets,
                                     60, 16, False))
    got = tnn._ivf_query(_t(Q), _t(X), _t(cent), _t(buckets).long(), 60)
    np.testing.assert_array_equal(got.numpy(), want)
    ct, bt = tnn._ivf_build(_t(X))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cent), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(buckets))


def test_aliases_and_small_n():
    """'hnsw' and 'ivf' name the same search; at n <= 4 * 256 every method
    is the exact search, as in the JAX package."""
    X = _x(1100, 2, 50)
    want = tnn.nn(X, 8, method='approx', device='cpu')
    for alias in ('hnsw', 'ivf'):
        np.testing.assert_array_equal(tnn.nn(X, 8, method=alias, device='cpu'), want)
    assert not (want == tnn.nn(X, 8, device='cpu')).all()
    small = X[:1024]
    np.testing.assert_array_equal(tnn.nn(small, 8, method='approx', device='cpu'),
                                  jnn.nn(small, 8, method='exact'))


def test_ancestral_sample_at_large_n():
    """Above 32768 points the ancestral pass works in blocks of 256 (the
    branch every large-n prior draw takes): the same draws as the JAX
    package's from the same noise and weights, on IVF neighbours."""
    from dgp_tpu.vecchia import core as jcore
    from dgp_tpu_torch.vecchia import core as tcore
    n = 33000
    X = _x(n, 1, 60)
    NN = tnn.nn(X / 0.3, 8, method='approx', device='cpu')
    w, sigma, idx, _ = tcore.cond_weights(_t(X), _t(NN), _t([0.3]), 1e-4, 'sexp')
    eps = np.random.RandomState(3).normal(size=(2, n)) * sigma.numpy()[None]
    want = np.asarray(jcore.ancestral_sample(jnp.asarray(eps), jnp.asarray(w.numpy()),
                                             jnp.asarray(idx.numpy())))
    got = tcore.ancestral_sample(_t(eps), w, idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-10)


def _layers(pkg):
    return pkg.combine([pkg.kernel(length=np.array([0.5]), name='sexp', nugget=1e-4)],
                       [pkg.kernel(length=np.array([0.5]), name='sexp', nugget=1e-4,
                                   nugget_est=True, scale_est=True, connect=np.arange(1))])


def _dgp_data(n, seed):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 1) * 2 - 1
    return X, np.sin(3 * X) + 0.05 * rs.randn(n, 1)


def test_dgp_switch_searches_with_ivf(monkeypatch):
    """At the threshold every GP node of a Vecchia dgp takes 'approx' and
    its neighbours are the JAX package's IVF search of its own scaled,
    ordered input; the node keeps the centroids for the next refresh.  A
    dense dgp at that size constructs too."""
    monkeypatch.setattr(tdgp, "APPROX_NN_N", 1000)
    X, Y = _dgp_data(1200, 5)
    dgp_tpu_torch.nb_seed(0)
    m = dgp_tpu_torch.dgp(X, Y, _layers(dgp_tpu_torch), vecchia=True, m=10, device='cpu')
    assert m.nn_method == 'approx'
    # the inputs the nodes were wired on: X, and (forwarded X, X) for layer 2
    for (nd,), In in zip(m.all_layer, (X, np.hstack([X, X]))):
        assert nd.nn_method == 'approx'
        np.testing.assert_array_equal(nd.NNarray, jnn.nn((In / nd.length)[nd.ord], 10,
                                                         method='approx'))
    assert m.all_layer[0][0]._ivf_cache['cent'].shape == (tnn._ivf_params(1200)[0], 1)
    dense = dgp_tpu_torch.dgp(X, Y, _layers(dgp_tpu_torch), device='cpu')
    assert dense.nn_method == 'approx' and dense.n_data == 1200


def test_refresh_nn_approx_layout_and_jax(monkeypatch):
    """The engine's device refresh of approximate nodes: the reference
    layout (test_vecchia.py::test_device_refresh_supports_approx), and on
    the permutation it drew, the JAX package's device search exactly."""
    monkeypatch.setattr(tdgp, "APPROX_NN_N", 1000)
    X, Y = _dgp_data(1200, 14)
    dgp_tpu_torch.nb_seed(1)
    m = dgp_tpu_torch.dgp(X, Y, _layers(dgp_tpu_torch), vecchia=True, m=10, device='cpu')
    eng = m.imp._engine()
    assert eng.supports_device_refresh()
    state = eng.get_state()
    nn_state = eng.refresh_nn(state, torch.Generator().manual_seed(0))
    for l, layer in enumerate(nn_state):
        for k, d in enumerate(layer):
            NN, ordv = d['NN'].numpy(), d['ord'].numpy()
            assert NN.shape == (1200, 11)
            assert sorted(ordv.tolist()) == list(range(1200))
            assert (NN[:, 0] == np.arange(1200)).all()
            valid = NN >= 0
            assert (valid[:, :-1] | ~valid[:, 1:]).all()       # -1 only at the tail
            assert (np.where(valid[:, 1:], NN[:, 1:], -2) < NN[:, :-1]).all()
            Xo = (eng._node_input(l, k, state[0]) / state[1][l][k]['length'])[d['ord']]
            np.testing.assert_array_equal(NN, np.asarray(jnn.nn_approx_dev(
                jnp.asarray(Xo.numpy()), 10)[0]))


def test_vecchia_gp_with_ivf_matches_jax(monkeypatch):
    """A Vecchia gp at the threshold, built by each package's own
    constructor from the same numpy seed: the same IVF neighbours, and
    train() ends at the JAX package's parameters (rtol 1e-6); its
    log-likelihood and its predictions through the IVF prediction search
    agree at rtol 1e-8."""
    monkeypatch.setattr(tgp, "APPROX_NN_N", 1500)
    rs = np.random.RandomState(8)
    X = rs.rand(1500, 1) * 2 - 1
    Y = np.sin(4 * X) + 0.05 * rs.randn(1500, 1)
    kw = dict(length=np.array([0.5]), nugget=1e-2, scale_est=True, nugget_est=True)
    kj = dgp_tpu.kernel(**kw)
    kj.nn_method = 'approx'
    np.random.seed(3)
    gj = dgp_tpu.gp(X, Y, kj, vecchia=True, m=15)
    np.random.seed(3)
    gt = dgp_tpu_torch.gp(X, Y, dgp_tpu_torch.kernel(**kw), vecchia=True, m=15,
                          device='cpu')
    assert gt.kernel.nn_method == 'approx'
    np.testing.assert_array_equal(gt.kernel.NNarray, gj.kernel.NNarray)
    gj.train()
    gt.train()
    params = [np.concatenate([g.kernel.scale, g.kernel.length, g.kernel.nugget])
              for g in (gt, gj)]
    np.testing.assert_allclose(*params, rtol=1e-6)
    np.testing.assert_allclose(gt.kernel.log_likelihood_func(),
                               gj.kernel.log_likelihood_func(), rtol=1e-8)
    z = np.linspace(-1, 1, 200)[:, None]
    for a, b in zip(gt.predict(z, m=30), gj.predict(z, m=30)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)


def test_interop_carries_the_search():
    """A JAX gp that searches with IVF comes across with its method and its
    centroid cache; the carried gp predicts as the JAX one does."""
    rs = np.random.RandomState(9)
    X = rs.rand(1300, 2)
    Y = np.sin(4 * X[:, :1]) * X[:, 1:] + 0.05 * rs.randn(1300, 1)
    kj = dgp_tpu.kernel(length=np.array([0.4]), nugget=1e-2, scale_est=True)
    kj.nn_method = 'approx'
    np.random.seed(4)
    gj = dgp_tpu.gp(X, Y, kj, vecchia=True, m=12)
    gt = gp_from_numpy(gj, device='cpu')
    assert gt.kernel.nn_method == 'approx'
    np.testing.assert_array_equal(gt.kernel._ivf_cache['cent'], gj.kernel._ivf_cache['cent'])
    z = np.random.RandomState(5).rand(100, 2)
    for a, b in zip(gt.predict(z, m=20), gj.predict(z, m=20)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    gt.kernel.ord_nn(ord=gt.kernel.ord)         # warm-started from the carried centroids
    np.testing.assert_array_equal(gt.kernel.NNarray, jnn.nn(
        (X / gj.kernel.length)[gj.kernel.ord], 12, method='approx',
        cache={'cent': gj.kernel._ivf_cache['cent']}))


def test_vecchia_dgp_ivf_ensemble(monkeypatch):
    """A Vecchia DGP at n = 1500 with approximate nodes trains (device
    refreshes at iterations 2 and 4 through the IVF search), and its
    emulator's predictions through the ensemble's IVF indices agree with
    the exact search's on the same imputations
    (tests/test_ensemble.py::test_compiled_ensemble_approx_nn)."""
    monkeypatch.setattr(tdgp, "APPROX_NN_N", 1000)
    X, Y = _dgp_data(1500, 5)
    dgp_tpu_torch.nb_seed(5)
    m = dgp_tpu_torch.dgp(X, Y, _layers(dgp_tpu_torch), vecchia=True, m=10, device='cpu')
    m.train(N=4, disable=True, chunk_size=2)
    assert all(np.isfinite(nd.para_path).all() for layer in m.all_layer for nd in layer)
    emu = dgp_tpu_torch.emulator(m.estimate(), N=3, device='cpu')
    xt = np.linspace(-1, 1, 400)[:, None]
    mu_a, var_a = emu.predict(xt, m=15)
    assert all(nd['ivf'] is not None for layer in emu._ens.spec for nd in layer)
    assert np.isfinite(mu_a).all() and (var_a >= 0).all()
    for layer_set in emu.all_layer_set:
        for layer in layer_set:
            for nd in layer:
                nd.nn_method = 'exact'
    emu._ens = None
    mu_e, _ = emu.predict(xt, m=15)
    assert np.sqrt(np.mean((mu_a - np.sin(3 * xt)) ** 2)) < 0.15
    assert np.mean(np.abs(mu_a - mu_e)) < 0.02
