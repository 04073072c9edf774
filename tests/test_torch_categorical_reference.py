"""dgp_tpu_torch's deep-GP classifier against the benchmark's plain
reference (`benchmark/reference/categorical.py`, `reference/vecchia.py`),
on seeded random data at small sizes on the CPU: the softmax Categorical
log-density on a candidate axis, K2's plain version in Matern-2.5 with 13
dynamic dims, one SEM iteration of the 13 -> 3 -> Categorical Vecchia DGP
judged by the benchmark cell's comparison (the program passes, the float32
control and every planted fault fail), and the spans and counters of its
likelihood layer and prior draws."""
import copy

import numpy as np
import pytest
import torch

import dgp_tpu_torch as dt
from benchmark.harness import core
from benchmark.harness.hooks import Hooks
from benchmark.reference import categorical as ref_cat
from benchmark.reference import vecchia as ref_v
from benchmark.traffic import sem_cat
from dgp_tpu_torch import config, likelihoods, tracing
from dgp_tpu_torch.models.compiled import CompiledDGP
from dgp_tpu_torch.ops import cuda_vecchia as cv

F64 = torch.float64
CELL = "dgp3_cat_n5000.sem"


@pytest.fixture(autouse=True)
def _keep_dtype():
    """The float32 control sets the package's working dtype; put it back."""
    before = config.default_dtype()
    yield
    config.set_default_dtype(before)


@pytest.mark.parametrize("K,n", [(1, 40), (9, 200)])
def test_categorical_llik_matches_the_reference_density(K, n):
    g = torch.Generator().manual_seed(K + n)
    f = 3.0 * torch.randn((K, n, 3), generator=g, dtype=F64)
    y = torch.randint(0, 3, (n, 1), generator=g).to(F64)
    got = likelihoods.categorical_llik(f, y, num_classes=3, link="softmax")
    want = ref_cat.loglik(f, y[:, 0])
    assert got.shape == (K,)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=0)


def test_k2_plain_matern_at_13_dynamic_dims_matches_the_reference():
    """K2's candidate sums over maintained angle views of 13 latent columns,
    all dynamic, against the reference's Vecchia log-likelihood of each
    candidate; and the gate takes the cell's blocks (m1 = 26, d = 13)."""
    n, d, m = 150, 13, 10
    g = torch.Generator().manual_seed(13)
    f = torch.rand((n, d), generator=g, dtype=F64)
    nu = 0.3 * torch.randn((n, d), generator=g, dtype=F64)
    y = torch.sin(3 * f.sum(1) / d) + 0.1 * torch.randn(n, generator=g, dtype=F64)
    length, nugget, scale = torch.tensor([1.7], dtype=F64), 1e-4, 0.8
    NN = ref_v.ordered_nn(f / length, m)
    rev = torch.flip(NN, dims=(1,))
    validT = (rev >= 0).T
    safeT = torch.where(validT, rev.T, 0)
    m1 = m + 1
    view = dict(ordv=torch.arange(n), cols=list(range(d)), s_lat=length.expand(d),
                safeT=safeT, validT=validT, dg=0)
    A = CompiledDGP._gather_latent_view(view, f)
    B = CompiledDGP._gather_latent_view(view, nu)
    sent = cv.sentinels(n, m1, F64, f.device)
    C = torch.where(validT[:, None, :], torch.zeros((m1, d, n), dtype=F64), sent[:, None, :])
    diag = torch.where(validT, torch.tensor(1.0 + nugget, dtype=F64), 1.0)
    yg = torch.where(validT, y[safeT], 0.0)
    theta = torch.linspace(-3.0, 3.0, 7, dtype=F64)
    ld, q = cv.block_loglik_multi_t(A, B, C, yg, diag, torch.cos(theta), torch.sin(theta),
                                    name="matern2.5", dl=d)
    got = -0.5 * (ld.sum(1) + q.sum(1) / scale)
    want = torch.stack([ref_v.loglik(torch.cos(t) * f + torch.sin(t) * nu, y, NN, scale,
                                     length, nugget, "matern2.5") for t in theta])
    torch.testing.assert_close(got, want, rtol=1e-11, atol=0)
    assert cv.use_kernel("K2", 26, 13)


def _small_run(seed, dtype="float64", n=60, m=8, ess_burn=1):
    spec, cfg, mix = (copy.deepcopy(x) for x in core.cell_files(CELL))
    spec.update(check_units=1, check_from=2)
    cfg["data"]["n"] = n
    cfg.update(vecchia_m=m, ess_burn=ess_burn)
    mix.update(warm_iterations=1, chunk=1)
    return core.Run(CELL, spec, cfg, mix, seed, 0.0, 0, "cpu", dtype)


def _one_iteration(run, fault=None):
    """The cell's comparison of one judged SEM iteration, with ``fault``
    planted under the timed path (and the warm-up) where one is given."""
    with Hooks() as hooks:
        if fault is not None:
            fault(hooks)
        session = sem_cat.setup(run)
        try:
            assert session.unit(0) == {"iterations": 1}
        finally:
            session.finish()
    return session, {c["name"]: c for c in session.check()}


def test_one_sem_iteration_passes_the_benchmark_replay():
    """One SEM iteration of the classifier, judged by the cell's comparison
    at its limits: both block ESS moves of every sweep replayed in their
    order, K2 at d = 13, the Categorical density, K3, K1 and the M-step's
    result over the 16 nodes."""
    run = _small_run(2**31 + 3)
    session, checks = _one_iteration(run)
    events = session.captures[0]["events"]
    assert [r["route"] for r in events] == list(sem_cat.SWEEP) * (run.config["ess_burn"] + 1)
    assert set(checks) == set(run.spec["limits"])
    for c in checks.values():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"], c


def test_float32_control_fails_the_comparison():
    _, checks = _one_iteration(_small_run(2**31 + 5, dtype="float32"))
    assert any(not c["value"] <= c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault,number", sem_cat.FAULTS[CELL],
                         ids=lambda v: getattr(v, "__name__", v))
def test_planted_fault_fails_its_number(fault, number):
    _, checks = _one_iteration(_small_run(2**31 + 3), fault)
    assert checks[number]["value"] > checks[number]["limit"], checks


def _classifier(n=60, seed=4):
    rs = np.random.RandomState(seed)
    X, Y, _ = sem_cat.design(rs, {"n": n, "input_dim": 13, "classes": 3, "domain": [0.0, 1.0],
                                  "function_scale": 2.0, "trend_scale": 3.0})
    k = dt.kernel
    layers = dt.combine([k(length=np.array([1.0]), name="matern2.5", nugget=1e-6)
                         for _ in range(13)],
                        [k(length=np.array([1.0]), name="matern2.5", scale_est=True,
                           nugget=1e-4, nugget_est=True) for _ in range(3)],
                        [dt.Categorical()])
    dt.nb_seed(0)
    return dt.dgp(X, Y, layers, vecchia=True, m=8, device="cpu")


def test_the_classifiers_spans_and_counters():
    """train(N=2, ess_burn=2): a sem.lik span for each evaluation of the
    Categorical density (its name, the candidates it evaluated, as
    lik.candidates counts them); one block sem.ess span a layer a sweep,
    with the columns it moves; prior.passes 13 + 3 (ess_burn + 1) an
    iteration (one batched pass a wide-layer node, one a class node a
    sweep) and prior.columns a column a node a sweep."""
    m = _classifier()
    N, burn = 2, 2
    with tracing.recording() as rec:
        m.train(N=N, ess_burn=burn, chunk_size=N, disable=True)
    sweeps = burn + 1
    lik = [s for s in rec.spans if s.name == "sem.lik"]
    assert lik and all(s.attrs["name"] == "Categorical" for s in lik)
    assert len(lik) == rec.counters["lik.evals"]
    assert sum(s.attrs["candidates"] for s in lik) == rec.counters["lik.candidates"]
    blocks = [s.attrs for s in rec.spans if s.name == "sem.ess"]
    assert blocks == [{"layer": 0, "route": "block", "cols": 13},
                      {"layer": 1, "route": "block", "cols": 3}] * (N * sweeps)
    assert rec.counters["prior.passes"] == N * (13 + 3 * sweeps)
    assert rec.counters["prior.columns"] == N * (13 + 3) * sweeps
