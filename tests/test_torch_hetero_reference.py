"""dgp_tpu_torch's likelihood layer against the benchmark's plain reference
of it (`benchmark/reference/hetero.py`), on seeded random data at small
sizes on the CPU: the Hetero log-density on a candidate axis, the exact
Vecchia draw of the mean against an explicit sparse factor, both draws
(Vecchia with full conditioning sets, and dense) against the dense
Gaussian conditional, one SEM iteration of the three-layer Hetero DGP
replayed by the benchmark's comparison, and the spans and counters of the
layer."""
import copy
import types

import numpy as np
import pytest
import torch

import dgp_tpu_torch as dt
from benchmark.harness import core
from benchmark.reference import hetero as ref_het
from benchmark.traffic import sem_lik
from dgp_tpu_torch import likelihoods, tracing
from dgp_tpu_torch.models.compiled import CompiledDGP
from dgp_tpu_torch.vecchia import core as vcore
from dgp_tpu_torch.vecchia import nn as vnn

F64 = torch.float64
CELL = "dgp3_hetero_n2000.sem"


def _case(n, d, seed):
    """Ordered inputs, noise variances, observations and the normals of a
    draw, from the seed."""
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((n, d), generator=g, dtype=F64) * 2 - 1
    Gamma = 0.01 + 0.05 * torch.rand(n, generator=g, dtype=F64)
    y = torch.sin(3 * X[:, 0]) + Gamma.sqrt() * torch.randn(n, generator=g, dtype=F64)
    z = torch.randn(n, generator=g, dtype=F64)
    return X, Gamma, y, z


def _imp_nn(X, m):
    """Each point's m - 1 nearest among all the others (the exact draw's
    self-excluded sets), as `CompiledDGP.refresh_nn` builds them."""
    return vnn._pred_nn_impl(X, X, m)[:, 1:]


def _draw_map(draw, k):
    """(mean, covariance) of an affine draw z -> draw(z) of k normals: its
    value at zero and the Gram matrix of its columns."""
    mean = draw(torch.zeros(k, dtype=F64))
    B = torch.stack([draw(e) - mean for e in torch.eye(k, dtype=F64)], dim=1)
    return mean, B @ B.T


@pytest.mark.parametrize("K,n", [(1, 40), (9, 200)])
def test_hetero_llik_matches_the_reference_density(K, n):
    g = torch.Generator().manual_seed(K + n)
    f = torch.randn((K, n, 2), generator=g, dtype=F64)
    f[..., 1] = f[..., 1] - 3.0
    y = torch.randn((n, 1), generator=g, dtype=F64)
    got = likelihoods.hetero_llik(f, y)
    want = ref_het.loglik(f[..., 0], f[..., 1], y[:, 0])
    assert got.shape == (K,)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("n,m,d", [(40, 5, 1), (120, 10, 2), (200, 8, 1)])
def test_post_het_vecch_matches_the_explicit_factor(n, m, d):
    """The program's blocked ancestral solve against U_ff^{-T} (z - U_yf^T
    y) from the explicit factor, from the same normals."""
    X, Gamma, y, z = _case(n, d, seed=n + m)
    scale, length = torch.tensor(1.3, dtype=F64), torch.full((d,), 0.3, dtype=F64)
    imp = _imp_nn(X, m)
    got = vcore.post_het_vecch(None, X, imp, Gamma, y, scale, length, 1e-4, 'sexp', normals=z)
    want = ref_het.exact_draw(X, imp, Gamma, y, scale, length, 'sexp', z)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-11


def test_full_sets_give_the_dense_conditional():
    """With every other point in each conditioning set (m >= n - 1) the
    stacked factor is exact: the reference's factor (no jitter) follows f |
    y for f ~ N(0, scale K) to rounding, and the program's draw follows it
    for f ~ N(0, scale K + jitter I) within the jitter's own effect (the
    jitter over the least noise variance, 1e-8: its blocks give the
    observation and latent slots of a point the jitter each, but not their
    covariance)."""
    n = 40
    _, Gamma, y, _ = _case(n, 1, seed=5)
    # a grid in a random order, so that K is well conditioned
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    X = torch.linspace(-1, 1, n, dtype=F64)[perm, None]
    scale, length = torch.tensor(0.8, dtype=F64), torch.tensor([0.1], dtype=F64)
    imp = _imp_nn(X, n)
    S = scale * ref_het.ref.corr(X, X, length, 'sexp')
    eye = torch.eye(n, dtype=F64)

    def gaps(got, want):
        return [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    ref = ref_het.factor_conditional(*ref_het.u_factor(X, imp, Gamma, scale, length, 'sexp',
                                                       jitter=0.0), y)
    assert max(gaps(ref, ref_het.dense_conditional(S, Gamma, y))) < 1e-12
    got = _draw_map(lambda e: vcore.post_het_vecch(None, X, imp, Gamma, y, scale, length, 1e-4,
                                                   'sexp', normals=e), n)
    assert max(gaps(got, ref_het.dense_conditional(S + ref_het.JITTER * eye, Gamma, y))) < 1e-7


def test_dense_post_het_matches_the_dense_conditional():
    """The dense exact draw (Matheron's update from 2n normals) has the mean
    and covariance of f | y for f ~ N(0, v)."""
    n = 30
    X, Gamma, y, _ = _case(n, 1, seed=6)
    v = 1.2 * ref_het.ref.corr(X, X, torch.tensor([0.3], dtype=F64), 'sexp') \
        + 1e-4 * torch.eye(n, dtype=F64)
    mu, C = ref_het.dense_conditional(v, Gamma, y)
    engine = types.SimpleNamespace(dtype=F64, device=torch.device('cpu'))
    got_mu, got_C = _draw_map(lambda e: CompiledDGP._post_het(
        engine, v, Gamma, y, None, normals=e.reshape(2, n).T), 2 * n)
    assert float((got_mu - mu).abs().max() / mu.abs().max()) < 1e-8
    assert float((got_C - C).abs().max() / C.abs().max()) < 1e-8


def _small_run(seed, n=100, m=8):
    spec, cfg, mix = (copy.deepcopy(x) for x in core.cell_files(CELL))
    spec.update(check_units=1, check_from=2)
    cfg["data"]["n"] = n
    cfg["vecchia_m"] = m
    mix.update(warm_iterations=2, chunk=1)
    return core.Run(CELL, spec, cfg, mix, seed, 0.0, 0, "cpu", "float64")


def test_one_sem_iteration_passes_the_benchmark_replay():
    """One SEM iteration of the three-layer Hetero Vecchia DGP, judged by
    the benchmark cell's comparison at its limits: the block ESS, the
    exact draws and the node-wise ESS replayed in their order, K3, K1 and
    the M-step's result."""
    run = _small_run(2**31 + 3)
    session = sem_lik.setup(run)
    try:
        assert session.unit(0) == {"iterations": 1}
    finally:
        session.finish()
    events = session.captures[0]["events"]
    assert [(k, r.get("route")) for k, r in events] == \
        list(sem_lik.SWEEP) * (run.config["ess_burn"] + 1)
    checks = session.check()
    assert {c["name"] for c in checks} == set(run.spec["limits"])
    for c in checks:
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"], c


def _hetero_dgp(vecchia):
    rs = np.random.RandomState(4)
    X = rs.uniform(-1, 1, (60, 1))
    Y = np.sin(3 * X) + 0.05 * np.exp(0.8 * X) * rs.randn(60, 1)
    k = dt.kernel
    layers = dt.combine([k(length=np.array([0.5]), name='sexp')],
                        [k(length=np.array([0.2]), name='sexp', scale_est=True,
                           connect=np.arange(1)) for _ in range(2)],
                        [dt.Hetero()])
    dt.nb_seed(0)
    return dt.dgp(X, Y, layers, vecchia=vecchia, m=8, device='cpu')


@pytest.mark.parametrize("vecchia", [True, False])
def test_the_likelihood_layers_spans_and_counters(vecchia):
    """train(N=2, ess_burn=2): one sem.exact_draw span (layer 1, its kind)
    and one exact_draws.<kind> count a sweep, which the engine's
    exact_draws reads; the block and node-wise ESS spans carry their
    routes; lik.evals counts the likelihood's calls, lik.candidates the
    states they evaluated."""
    m = _hetero_dgp(vecchia)
    engine = m.imp._engine()
    kind = 'vecchia' if vecchia else 'dense'
    before = dict(engine.exact_draws)
    with tracing.recording() as rec:
        m.train(N=2, ess_burn=2, chunk_size=2, disable=True)
    sweeps = 2 * 3
    draws = [s for s in rec.spans if s.name == "sem.exact_draw"]
    assert len(draws) == sweeps
    assert all(s.attrs == {"layer": 1, "kind": kind} for s in draws)
    assert rec.counters["exact_draws." + kind] == sweeps
    assert "exact_draws." + ('dense' if vecchia else 'vecchia') not in rec.counters
    after = engine.exact_draws
    assert after[kind] - before[kind] == sweeps
    assert sum(after.values()) - sum(before.values()) == sweeps
    routes = [s.attrs.get("route") for s in rec.spans if s.name == "sem.ess"]
    assert routes.count("block") == sweeps and routes.count("nodewise") == sweeps
    assert rec.counters["lik.evals"] >= sweeps
    assert rec.counters["lik.candidates"] > rec.counters["lik.evals"]
