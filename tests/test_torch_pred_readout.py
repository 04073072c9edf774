"""Every node-level prediction reads its results back through one
read-out (`dgp_tpu_torch.models.node.read_out`), on the CPU: the mean and
the variance come to the host in one copy (``host_reads.predict_out``)
with no separate check read (``host_reads.jitter_check``), and a Vecchia
prediction whose row comes out non-finite at extra diagonal 0 takes that
row, and that row alone, from the first rung of
`vecchia.core.PRED_JITTER_RUNGS`, at one more read.

The calls: `kernel.gp_prediction` dense and Vecchia, `linkgp_prediction`
dense and Vecchia, `linkgp_prediction_full` and the Vecchia `gp.loo`.
This file imports no JAX."""
import copy

import numpy as np
import pytest

import dgp_tpu_torch as dt
from dgp_tpu_torch import tracing
from dgp_tpu_torch.vecchia import core as vcore

#: the row made non-finite at extra diagonal 0
ROW = 2


def _models(vecchia):
    """A small gp, and a copy of its node as a linked node: one Gaussian
    input and one global input, with its dense statistics made."""
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (60, 2))
    Y = np.sin(3 * X[:, :1]) + np.cos(2 * X[:, 1:])
    dt.nb_seed(1)
    g = dt.gp(X, Y, dt.kernel(length=np.array([0.5]), scale_est=True, nugget=1e-3),
              vecchia=vecchia, m=10, device='cpu')
    g.kernel.compute_stats()
    node = copy.deepcopy(g.kernel)
    node.input, node.global_input = X[:, :1], X[:, 1:]
    node.compute_stats()
    return g, node


@pytest.fixture(scope="module")
def models():
    return {False: _models(False), True: _models(True)}


def _queries():
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (13, 2))
    m, z, m_z = (rs.uniform(-1, 1, (13, 1)) for _ in range(3))
    v, v_z = (rs.uniform(0.01, 0.1, (13, 1)) for _ in range(2))
    return x, m, v, z, m_z, v_z


def _gp_prediction(g, node):
    x = _queries()[0]
    return g.kernel.gp_prediction(x, None)


def _linkgp_prediction(g, node):
    _, m, v, z, _, _ = _queries()
    return node.linkgp_prediction(m, v, z)


def _linkgp_prediction_full(g, node):
    _, m, v, _, m_z, v_z = _queries()
    return node.linkgp_prediction_full(m, v, m_z, v_z, None)


def _loo(g, node):
    return g.loo(m=10)


#: (call, Vecchia model?, the `vecchia.core` function it runs, or None)
CALLS = {
    "gp_prediction-dense": (_gp_prediction, False, None),
    "gp_prediction-vecchia": (_gp_prediction, True, "gp_vecch"),
    "linkgp_prediction-dense": (_linkgp_prediction, False, None),
    "linkgp_prediction-vecchia": (_linkgp_prediction, True, "link_gp_vecch"),
    "linkgp_prediction_full": (_linkgp_prediction_full, False, None),
    "loo-vecchia": (_loo, True, "loo_gp_vecch"),
}
CASES = [(c, False) for c in CALLS] + [(c, True) for c, (_, _, f) in CALLS.items() if f]


def _nan_at_zero(monkeypatch, name):
    """Make ``vcore.<name>``'s mean non-finite in row `ROW` at extra
    diagonal 0; returns {extra: (mean, var)} of the true outputs."""
    orig, seen = getattr(vcore, name), {}

    def f(*args):
        mean, var = orig(*args)
        seen[float(args[-1])] = (mean.numpy().copy(), var.numpy().copy())
        if args[-1] == 0:
            mean = mean.clone()
            mean[ROW] = float('nan')
        return mean, var
    monkeypatch.setattr(vcore, name, f)
    return seen


@pytest.mark.parametrize("call,nan", CASES,
                         ids=[f"{c}-{'nan' if n else 'finite'}" for c, n in CASES])
def test_a_node_prediction_reads_its_results_once(models, monkeypatch, call, nan):
    fn, vecchia, core_fn = CALLS[call]
    plain = [np.ravel(a) for a in fn(*models[vecchia])]
    seen = _nan_at_zero(monkeypatch, core_fn) if nan else None
    with tracing.recording() as rec:
        mean, var = (np.ravel(a) for a in fn(*models[vecchia]))
    assert rec.counters["host_reads.predict_out"] == (2 if nan else 1)
    assert "host_reads.jitter_check" not in rec.counters
    if not nan:
        np.testing.assert_array_equal(mean, plain[0])
        np.testing.assert_array_equal(var, plain[1])
        return
    assert sorted(seen) == [0.0, vcore.PRED_JITTER_RUNGS[0]]
    rung = seen[vcore.PRED_JITTER_RUNGS[0]]
    others = np.arange(len(mean)) != ROW
    for got, want, again in zip((mean, var), plain, rung):
        assert got[ROW] == again[ROW]
        np.testing.assert_array_equal(got[others], want[others])
