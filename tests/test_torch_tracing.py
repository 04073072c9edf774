"""The port's spans and counters (`dgp_tpu_torch.tracing`), on the CPU:

1. spans nest and share their root's id, each host thread keeps its own
   stack, and `parallel.mesh.map_shares` carries the caller's span into
   its threads; counts from many threads are all kept;
2. with no recording on, nothing is recorded;
3. a small Vecchia DGP's `train` and an `lgp.predict` give the same
   outputs and random states, bit for bit, with recording on and off, and
   their spans have one root each, as an `emulator.predict` has;
4. the ESS and L-BFGS counters equal counts taken around the evaluators,
   and ``prior.passes`` the ancestral passes of the prior draws of a
   Gaussian and a Hetero Vecchia DGP;
5. under torch.profiler a `record_function` inside a span lies inside it
   on the profiler's clock;
6. `idle_by_span` on made-up events.

The test marked ``card`` (a span around one K2 launch and its read holds
the kernel's device record) needs an NVIDIA card; this file imports no
JAX, so on the card it runs without the test directory's conftest:
``python -m pytest tests/test_torch_tracing.py -m card --noconftest``.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dgp_tpu_torch
from dgp_tpu_torch import rng, tracing
from dgp_tpu_torch.models import compiled, mstep
from dgp_tpu_torch.ops import cuda_vecchia as cv
from dgp_tpu_torch.parallel import mesh as pmesh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


# ----------------------------------------------------------------------
# 1. spans, threads, counts
# ----------------------------------------------------------------------
def test_spans_nest_and_share_their_roots_id():
    with tracing.recording() as rec:
        with tracing.span("a", k=1):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("b"):
                pass
        with tracing.span("a"):
            pass
    assert tracing.last() is rec and rec.end_ns is not None
    a1, a2 = _by_name(rec, "a")
    b1, b2 = _by_name(rec, "b")
    c, = _by_name(rec, "c")
    assert a1.parent is None and a1.root == a1.id and a1.attrs == {"k": 1}
    assert (b1.parent, b2.parent, c.parent) == (a1.id, a1.id, b1.id)
    assert {b1.root, b2.root, c.root} == {a1.id}
    assert a2.parent is None and a2.root == a2.id != a1.id
    assert a1.start_ns <= b1.start_ns <= c.start_ns <= c.end_ns <= b1.end_ns \
        <= b2.start_ns <= b2.end_ns <= a1.end_ns <= a2.start_ns


def test_each_host_thread_keeps_its_own_stack():
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span("outer", tag=tag):
            gate.wait()
            with tracing.span("inner", tag=tag):
                gate.wait()

    with tracing.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    outer = {s.attrs["tag"]: s for s in _by_name(rec, "outer")}
    for s in _by_name(rec, "inner"):
        o = outer[s.attrs["tag"]]
        assert (s.parent, s.root, s.thread) == (o.id, o.id, o.thread)
    assert outer["x"].parent is None and outer["y"].parent is None
    assert outer["x"].thread != outer["y"].thread


def test_map_shares_carries_the_callers_span_into_its_threads():
    cpu = torch.device("cpu")

    def share(dev, sl):
        with tracing.span("share", start=sl.start):
            return threading.get_ident()

    with tracing.recording() as rec:
        with tracing.span("call") as call:
            idents = pmesh.map_shares((cpu, cpu), 10, share)
    assert len(idents) == 2
    spans = _by_name(rec, "share")
    assert len(spans) == 2 and all((s.parent, s.root) == (call.id, call.id) for s in spans)
    assert all(s.thread != call_s.thread for s in spans for call_s in _by_name(rec, "call"))


def test_counts_from_many_threads_are_all_kept():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.reset("stress.")
        with tracing.recording() as rec:
            def work():
                for _ in range(2000):
                    tracing.count("stress.n")
                    with tracing.span("stress"):
                        pass
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tracing.totals("stress.") == {"stress.n": 32000}
    assert rec.counters["stress.n"] == 32000 and len(_by_name(rec, "stress")) == 32000
    tracing.reset("stress.")
    assert tracing.totals("stress.") == {}


# ----------------------------------------------------------------------
# 2.-4. the program's spans and counters
# ----------------------------------------------------------------------
def _data(n=120, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.uniform(-1, 1, (n, 1))
    return X, np.sin(4 * X) + 0.05 * rs.randn(n, 1)


def _layers():
    k = dgp_tpu_torch.kernel
    return dgp_tpu_torch.combine(
        [k(length=np.array([0.5]), name='sexp', nugget=1e-4)],
        [k(length=np.array([0.5]), name='sexp', scale_est=True, nugget_est=True,
           connect=np.arange(1), nugget=1e-4)])


def _model(seed=0):
    X, Y = _data()
    dgp_tpu_torch.nb_seed(seed)
    return dgp_tpu_torch.dgp(X, Y, _layers(), vecchia=True, m=10, device='cpu')


def _rng_states():
    return (np.random.get_state()[1].copy(), rng.next_generator('cpu').get_state())


def _trained(record, seed=0, N=5):
    m = _model(seed)
    if record:
        with tracing.recording() as rec:
            m.train(N=N, chunk_size=2, ess_burn=2, disable=True)
    else:
        rec = None
        m.train(N=N, chunk_size=2, ess_burn=2, disable=True)
    return m, rec


def test_off_records_nothing():
    before = tracing.last()
    n_before = None if before is None else len(before.spans)
    assert tracing.span("a") is tracing.span("b")
    _trained(False, N=2)
    after = tracing.last()
    assert after is before and (after is None or len(after.spans) == n_before)


def test_train_is_the_same_with_recording_on_and_off():
    (m_off, _), states_off = _trained(False), _rng_states()
    (m_on, rec), states_on = _trained(True), _rng_states()
    for a, b in zip(states_off, states_on):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for l_off, l_on in zip(m_off.all_layer, m_on.all_layer):
        for a, b in zip(l_off, l_on):
            np.testing.assert_array_equal(a.para_path, b.para_path)
            np.testing.assert_array_equal(a.output, b.output)
            np.testing.assert_array_equal(a.NNarray, b.NNarray)
    root, = [s for s in rec.spans if s.parent is None]
    assert root.name == "sem.train" and root.attrs == {"N": 5}
    assert all(s.root == root.id for s in rec.spans)
    assert len(_by_name(rec, "sem.istep")) == len(_by_name(rec, "sem.mstep")) == 5
    assert len(_by_name(rec, "sem.chunk")) == 4   # 1, 1, 2, 1: refreshes at 2 and 4
    assert len(_by_name(rec, "nn.refresh")) == 2
    reads = sum(v for k, v in rec.counters.items() if k.startswith("host_reads."))
    assert len(_by_name(rec, "host_read")) == reads
    assert rec.counters["host_reads.finite_check"] == 4
    assert len(_by_name(rec, "lbfgs.eval")) == rec.counters["lbfgs.evals"]


def test_ess_and_lbfgs_counters_match_counts_taken_around_the_evaluators(monkeypatch):
    taken = {"rounds": 0, "candidates": 0, "transitions": 0, "moves": 0, "fg": 0}
    ess_update, vecch_fg = compiled.ess_update, mstep._vecch_fg

    def counted_ess(gen, f, nu, log_lik_fn, log_lik_angles=None, **kw):
        def angles(cosv, sinv):
            taken["rounds"] += 1
            taken["candidates"] += len(cosv)
            return log_lik_angles(cosv, sinv)
        taken["transitions"] += 1
        out = ess_update(gen, f, nu, log_lik_fn, log_lik_angles=angles, **kw)
        if kw.get("return_angle"):
            taken["moves"] += out[1] != (1.0, 0.0)
        else:
            taken["moves"] += not torch.equal(out, f)
        return out

    def counted_fg(*args, **kw):
        taken["fg"] += 1
        return vecch_fg(*args, **kw)

    m = _model()
    monkeypatch.setattr(compiled, "ess_update", counted_ess)
    monkeypatch.setattr(mstep, "_vecch_fg", counted_fg)
    with tracing.recording() as rec:
        m.train(N=3, chunk_size=2, ess_burn=2, disable=True)
    c = rec.counters
    assert taken["rounds"] > taken["transitions"] == 3 * 3 > 0
    assert (c["ess.rounds"], c["ess.candidates"], c["ess.transitions"], c["ess.moves"]) == \
        (taken["rounds"], taken["candidates"], taken["transitions"], taken["moves"])
    assert c["host_reads.ess_round"] == taken["rounds"]
    assert len(_by_name(rec, "sem.ess.round")) == taken["rounds"]
    assert len(_by_name(rec, "sem.ess")) == taken["transitions"]
    assert c["lbfgs.evals"] == taken["fg"] > 0



def _hetero_model():
    X, Y = _data(60)
    k = dgp_tpu_torch.kernel
    layers = dgp_tpu_torch.combine(
        [k(length=np.array([0.5]), name='sexp')],
        [k(length=np.array([0.2]), name='sexp', scale_est=True, connect=np.arange(1))
         for _ in range(2)],
        [dgp_tpu_torch.Hetero()])
    dgp_tpu_torch.nb_seed(0)
    return dgp_tpu_torch.dgp(X, Y, layers, vecchia=True, m=8, device='cpu')


@pytest.mark.parametrize("model,per_sweep", [(_model, 0), (_hetero_model, 1)],
                         ids=["gaussian", "hetero"])
def test_prior_passes_an_iteration(model, per_sweep):
    """train(N=2, ess_burn=2): prior.passes counts 1 + per_sweep (ess_burn
    + 1) ancestral passes an iteration, one a sem.prior_draw span: the
    layer-0 node's one batched draw for every sweep, and in the Hetero DGP
    its log-variance node's draw a sweep (the mean's is exact).  At
    ess_burn 10 these are the 1 and 12 of the benchmark's vsi_n1e5.sem and
    dgp3_hetero_n2000.sem; prior.columns counts a node's column a sweep."""
    N, burn = 2, 2
    m = model()
    with tracing.recording() as rec:
        m.train(N=N, chunk_size=N, ess_burn=burn, disable=True)
    sweeps = burn + 1
    assert rec.counters["prior.passes"] == N * (1 + per_sweep * sweeps)
    assert len(_by_name(rec, "sem.prior_draw")) == rec.counters["prior.passes"]
    assert rec.counters["prior.columns"] == N * sweeps * (1 + per_sweep)

def _lgp_system():
    rs = np.random.RandomState(1)
    X1 = rs.uniform(-1, 1, (80, 1))
    Y1 = np.sin(3 * X1) + 0.01 * rs.randn(80, 1)
    X2 = rs.uniform(0, 1, (80, 1))
    Y2 = np.cos(5 * X2) + 0.05 * rs.randn(80, 1)
    dgp_tpu_torch.nb_seed(3)
    k = dgp_tpu_torch.kernel
    g = dgp_tpu_torch.gp(X1, Y1, k(length=np.array([1.]), name='matern2.5', scale_est=True,
                                   nugget_est=True), vecchia=True, m=10, device='cpu')
    m2 = dgp_tpu_torch.dgp(X2, Y2, _layers(), vecchia=True, m=10, device='cpu')
    c1 = dgp_tpu_torch.container(g.export(), local_input_idx=np.array([0]), device='cpu')
    c2 = dgp_tpu_torch.container(m2.estimate(), local_input_idx=np.array([0]), device='cpu')
    return dgp_tpu_torch.lgp([[c1], [c2]], N=3, device='cpu')


def test_lgp_predict_is_the_same_with_recording_on_and_off():
    system = _lgp_system()
    z = np.linspace(-1, 1, 40)[:, None]
    before = _rng_states()
    mu_off, var_off = system.predict(z, m=20)
    states_off = _rng_states()
    with tracing.recording() as rec:
        mu_on, var_on = system.predict(z, m=20)
    for a, b in zip(states_off + before, _rng_states() + states_off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(mu_off[0], mu_on[0])
    np.testing.assert_array_equal(var_off[0], var_on[0])
    root, = [s for s in rec.spans if s.parent is None]
    assert root.name == "lgp.predict" and all(s.root == root.id for s in rec.spans)
    assert len(_by_name(rec, "predict.imputation")) == 3
    kinds = sorted((s.attrs["kind"], s.attrs["layer"]) for s in _by_name(rec, "predict.container"))
    assert kinds == [("dgp", 1)] * 3 + [("gp", 0)] * 3
    # model 1's kriging once (the imputations share its container), and per
    # imputation model 2's Vecchia layer 1 and its dense layer 2 (wired to
    # model 1's output)
    assert len(_by_name(rec, "predict.kriging")) == 1
    assert sorted(s.attrs["kind"] for s in _by_name(rec, "predict.linked_moments")) == \
        ["dense"] * 3 + ["vecchia"] * 3
    # one read of mean and variance per node call (`node.read_out`)
    assert rec.counters["host_reads.predict_out"] == 1 + 3 * 2
    assert len(_by_name(rec, "host_read")) == sum(
        v for k, v in rec.counters.items() if k.startswith("host_reads."))


def test_emulator_predict_is_one_root_with_one_read():
    m, _ = _trained(False, N=2)
    emu = dgp_tpu_torch.emulator(m.estimate(), N=2, device='cpu')
    with tracing.recording() as rec:
        emu.predict(np.linspace(-1, 1, 30)[:, None], m=10)
    root, = [s for s in rec.spans if s.parent is None]
    assert root.name == "emulator.predict" and all(s.root == root.id for s in rec.spans)
    # the Vecchia ensemble: layer 1's kriging and layer 2's linked moments
    # per imputation, after one search each; one read of all outputs
    assert len(_by_name(rec, "predict.kriging")) == 1
    assert [s.attrs["kind"] for s in _by_name(rec, "predict.linked_moments")] == ["vecchia"] * 2
    assert len(_by_name(rec, "predict.nn_search")) == 3
    assert rec.counters == {"host_reads.predict_out": 1}


# ----------------------------------------------------------------------
# 5. the profiler's clock
# ----------------------------------------------------------------------
def test_a_profiler_event_inside_a_span_lies_inside_it_on_one_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            time.sleep(0.002)
            with record_function("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    rec = tracing.last()
    outer, = _by_name(rec, "outer")
    e, = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert outer.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= outer.end_ns
    # the recording began with the profiler, and ended with it
    with tracing.span("after"):
        pass
    assert rec.end_ns is not None and not _by_name(rec, "after")


# ----------------------------------------------------------------------
# 6. the join with a profiler's events
# ----------------------------------------------------------------------
def test_idle_by_span_on_made_up_events():
    S = tracing.Span
    spans = [S(1, None, 1, "root", 0, 1_000_000, {}, 0),            # 0-1000 us
             S(2, 1, 1, "child", 100_000, 400_000, {}, 0),          # 100-400 us
             S(3, 1, 1, "child", 600_000, 700_000, {}, 0),          # 600-700 us
             S(4, None, 4, "root", 2_000_000, 2_100_000, {}, 0)]    # 2000-2100 us
    events = [("k1", True, 50.0, 150.0),
              ("k2", True, 120.0, 300.0),                  # overlaps k1
              ("Memcpy DtoH (Device -> Pageable)", True, 390.0, 395.0),
              ("k3", True, 650.0, 800.0),
              ("cudaLaunchKernel", False, 40.0, 45.0),
              ("cudaLaunchKernel", False, 110.0, 115.0),
              ("cuLaunchKernel", False, 640.0, 641.0),
              ("cudaMemcpyAsync", False, 380.0, 396.0),
              ("k4", True, 2050.0, 2300.0)]
    t = tracing.idle_by_span(events, spans)
    assert t["root"]["calls"] == 2 and t["child"]["calls"] == 2
    assert t["root"]["ms"] == pytest.approx(1.1)
    assert t["root"]["self_ms"] == pytest.approx(1.1 - 0.4)
    assert t["child"]["self_ms"] == pytest.approx(0.4)
    # busy: root 50-300, 390-395, 650-800 and 2050-2100; children 100-300,
    # 390-395 and 650-700
    assert t["root"]["busy_ms"] == pytest.approx((250 + 5 + 150 + 50) / 1e3)
    assert t["root"]["idle_ms"] == pytest.approx(1.1 - 0.455)
    assert t["child"]["busy_ms"] == pytest.approx((200 + 5 + 50) / 1e3)
    assert t["child"]["idle_ms"] == pytest.approx(0.4 - 0.255)
    assert (t["root"]["launches"], t["child"]["launches"]) == (3, 2)
    assert (t["root"]["dtoh"], t["child"]["dtoh"]) == (1, 1)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.card
def test_a_span_around_a_k2_launch_and_its_read_holds_its_device_record(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(0)
    m1, d, n = 26, 2, 4000
    A, B, C = (torch.randn((m1, d, n), generator=g, dtype=torch.float64, device=cuda)
               for _ in range(3))
    yg = torch.randn((m1, n), generator=g, dtype=torch.float64, device=cuda)
    diag = torch.ones((m1, n), dtype=torch.float64, device=cuda)
    cosv, sinv = [1.0, 0.6], [0.0, 0.8]
    cv.block_loglik_multi_t(A, B, C, yg, diag, cosv, sinv, name='sexp')   # build, warm
    torch.cuda.synchronize()
    before = cv.launch_counts()["block_loglik_multi_t"]["launches"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("k2"):
            ld, q = cv.block_loglik_multi_t(A, B, C, yg, diag, cosv, sinv, name='sexp')
            tracing.to_host(ld.sum(1) + q.sum(1), "test")
    assert cv.launch_counts()["block_loglik_multi_t"]["launches"] == before + 1
    span, = _by_name(tracing.last(), "k2")
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and "block_loglik_multi" in e.name()]
    assert len(dev) == 1
    e = dev[0]
    assert span.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.end_ns
    events = [(x.name(), x.device_type() == DeviceType.CUDA, x.start_ns() / 1e3,
               (x.start_ns() + x.duration_ns()) / 1e3)
              for x in prof.profiler.kineto_results.events()]
    t = tracing.idle_by_span(events)
    assert t["k2"]["launches"] >= 1 and t["k2"]["dtoh"] == 1 and t["k2"]["busy_ms"] > 0
