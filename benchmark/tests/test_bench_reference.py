"""The plain reference against the port's CPU path at small sizes, on the
same inputs: they compute the same quantities."""
import numpy as np
import pytest
import torch

from benchmark.reference import ess as ref_ess
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference import predict as ref_p
from benchmark.reference import vecchia as ref_v

F64 = dict(dtype=torch.float64)


@pytest.fixture
def problem():
    g = torch.Generator().manual_seed(3)
    X = torch.rand((300, 2), generator=g, **F64)
    y = torch.sin(4 * X[:, 0]) + 0.1 * torch.randn(300, generator=g, **F64)
    return X, y, ref_v.ordered_nn(X, 8)


@pytest.mark.parametrize("name", ["sexp", "matern2.5"])
def test_loglik_and_weights(problem, name):
    from dgp_tpu_torch.vecchia import core as vcore
    X, y, NN = problem
    length, nugget, scale = torch.tensor([0.3, 0.5], **F64), 1e-3, 0.7
    ll = vcore.vecchia_llik(X, y, NN, scale, length, nugget, torch.ones(300, **F64), name)
    assert float(ref_v.loglik(X, y, NN, scale, length, nugget, name)) == pytest.approx(
        float(ll), rel=1e-10)
    w, sigma, _, _ = vcore.cond_weights(X, NN, length, nugget, name)
    w_r, s_r = ref_v.cond_weights(X, NN, length, nugget, name)
    assert torch.allclose(w, w_r, rtol=1e-8, atol=1e-10)
    assert torch.allclose(sigma, s_r, rtol=1e-10)


def test_objective_and_lbfgs_against_the_ports(problem):
    from dgp_tpu_torch.ops import lbfgs
    from dgp_tpu_torch.vecchia import core as vcore
    X, y, NN = problem
    kw = dict(name="sexp", n_length=1, scale_est=True, nugget_est=True, fixed_scale=1.0,
              fixed_nugget=None, n_orig=300, sum_residual=None, prior_name="ga",
              prior_coef=np.array([0.6, 0.3]))

    def port(lt):
        nll, g, scale = vcore.vecchia_nllik_fg(lt[0], X, y, NN, torch.ones(300, **F64), **kw)
        return nll[None], g[None], torch.as_tensor(scale)[None]
    obj = ref_v.NodeObjective(X, y, NN, "sexp", n_length=1, nugget_est=True, nugget=None,
                              scale_est=True, scale=None, prior_coef=(0.6, 0.3))
    lt0 = torch.log(torch.tensor([0.5, 1e-2], **F64))
    nll, g, s = obj(lt0)
    nll_p, g_p, s_p = port(lt0[None])
    assert float(nll) == pytest.approx(float(nll_p[0]), rel=1e-10)
    assert torch.allclose(g, g_p[0], rtol=1e-8)
    lb = torch.tensor([-1e300, np.log(1e-8)], **F64)
    ub = torch.full((2,), 1e300, **F64)
    x_p, _, nfev_p, _ = lbfgs.minimize(port, lt0[None], lb[None], ub[None], maxfun=16,
                                       history=4, has_aux=True)
    x_r, _, nfev_r, _ = ref_lbfgs.minimize(obj, lt0, lb, ub, 16, history=4)
    assert nfev_r == int(nfev_p[0])
    assert torch.allclose(x_r, x_p[0], rtol=1e-7)


def test_predictions_against_the_ports(problem):
    from dgp_tpu_torch import gp_core
    from dgp_tpu_torch.vecchia import core as vcore
    X, y, _ = problem
    g = torch.Generator().manual_seed(5)
    q = torch.rand((40, 2), generator=g, **F64)
    length, nugget, scale = torch.tensor([0.3]), 1e-3, 0.7
    length = length.to(torch.float64)
    nn = ref_p.exact_nn(q / length, X / length, 10)
    ones = torch.ones(300, **F64)
    m, v = vcore.gp_vecch(q, X, nn, y, scale, length, nugget, ones, "sexp")
    m_r, v_r = ref_p.gp_vecch(q, X, nn, y, scale, length, nugget, "sexp")
    assert torch.allclose(m, m_r, rtol=1e-8, atol=1e-12)
    assert torch.allclose(v, v_r, rtol=1e-8)
    mq, vq = q[:, :1], 0.01 * q[:, 1:]
    z = q[:, 1:]
    nn1 = ref_p.exact_nn(q / length, X / length, 10)
    m, v = vcore.link_gp_vecch(mq, vq, z, X[:, :1], X[:, 1:], nn1, y, scale, length, nugget,
                               ones, "sexp")
    m_r, v_r = ref_p.link_vecch(mq, vq, z, X[:, :1], X[:, 1:], nn1, y, scale, length, nugget)
    assert torch.allclose(m, m_r, rtol=1e-8, atol=1e-12)
    assert torch.allclose(v, v_r, rtol=1e-7)
    Rinv, Rinv_y = gp_core.compute_stats(X, y, length, nugget, name="sexp")
    mm, vv = q, 0.01 * q
    m, v = gp_core.linkgp_predict(mm, vv, None, X, None, Rinv, Rinv_y, scale, length, nugget,
                                  name="sexp")
    m_r, v_r = ref_p.link_dense(mm, vv, X, y, scale, length, nugget)
    assert torch.allclose(m, m_r, rtol=1e-7, atol=1e-10)
    assert torch.allclose(v, v_r, rtol=1e-6)


@pytest.mark.parametrize("spec", [4, 8])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ess_replay_against_the_ports(problem, spec, seed):
    """The replayed transition accepts the latent that the port's sampler
    accepts, from the sampler's generator state and the angles it tried."""
    from dgp_tpu_torch.ess import ess_update
    X, y, NN = problem
    length, nugget, scale = torch.tensor([0.3, 0.5], **F64), 1e-3, 0.7
    g = torch.Generator().manual_seed(seed)
    f = torch.randn((300, 1), generator=g, **F64)
    nu = torch.randn((300, 1), generator=g, **F64)

    def loglik(lat):
        return ref_v.loglik(torch.cat([lat, X[:, 1:]], 1), y, NN, scale, length, nugget, "sexp")
    tried = []

    def angles(cosv, sinv):
        tried.extend(zip(cosv, sinv))
        return torch.stack([loglik(c * f + s * nu) for c, s in zip(cosv, sinv)])
    gen = torch.Generator().manual_seed(100 + seed)
    state = gen.get_state()
    f_new = ess_update(gen, f, nu, loglik, log_lik_angles=angles, spec=spec)
    u0, t0 = ref_ess.first_uniforms(state)
    got, i = ref_ess.transition(f, nu, loglik, u0, t0, tried[1:])
    assert torch.equal(got, f_new)
    assert torch.equal(ref_ess.transition(f, nu, loglik, u0, t0, tried[1:i + 2])[0], f_new)
    assert ref_ess.transition(f, nu, loglik, u0, t0, tried[1:i + 1]) is None
    assert ref_ess.transition(f, nu, loglik, u0, (t0 + 0.1) % 1.0, tried[1:]) is None
