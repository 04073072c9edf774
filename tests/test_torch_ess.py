"""dgp_tpu_torch.ess: the speculative sampler accepts exactly what the
sequential sampler accepts when both are fed the same uniforms, and a chain
of ESS transitions reproduces a closed-form Gaussian posterior (the
stationarity pattern of tests/test_ess.py)."""
import math

import numpy as np
import pytest
import torch

from dgp_tpu_torch.ess import ess_update

torch.set_num_threads(1)


class _Uniforms:
    """A numpy stream of uniforms in the order the sampler consumes them."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.drawn = 0

    def __call__(self, k):
        self.drawn += k
        return self.rs.uniform(size=k).tolist()


def _problem(seed):
    rs = np.random.RandomState(seed)
    n = 10
    X = np.linspace(0, 1, n)[:, None]
    S = np.exp(-((X - X.T) / 0.3) ** 2) + 1e-8 * np.eye(n)
    L = np.linalg.cholesky(S)
    y = L @ rs.normal(size=n)
    f = torch.as_tensor(L @ rs.normal(size=n))
    nu = torch.as_tensor(L @ rs.normal(size=n))
    y_t = torch.as_tensor(y)

    def log_lik(fp):
        # a sharp likelihood, so that many transitions need several rounds
        return -0.5 * torch.sum((y_t - fp) ** 2) / 1e-3

    return f, nu, log_lik


@pytest.mark.parametrize("spec,angles", [(4, False), (4, True), (8, True)])
def test_speculative_equals_sequential_with_same_uniforms(spec, angles):
    multi_round = 0
    for seed in range(300):
        f, nu, log_lik = _problem(seed)
        u_seq = _Uniforms(seed)
        f_seq, ang_seq = ess_update(None, f, nu, log_lik, spec=1,
                                    return_angle=True, uniform=u_seq)
        kw = {}
        if angles:
            def ll_ang(cosv, sinv):
                c = torch.as_tensor(cosv, dtype=f.dtype)[:, None]
                s = torch.as_tensor(sinv, dtype=f.dtype)[:, None]
                return torch.stack([log_lik(fp) for fp in c * f + s * nu])
            kw['log_lik_angles'] = ll_ang
        u_spec = _Uniforms(seed)
        f_spec, ang_spec = ess_update(None, f, nu, log_lik, spec=spec,
                                      return_angle=True, uniform=u_spec, **kw)
        np.testing.assert_allclose(f_spec.numpy(), f_seq.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ang_spec, ang_seq, rtol=1e-12, atol=1e-12)
        multi_round += u_spec.drawn > 2 + spec
    # the comparison covered transitions that needed more than one round
    assert multi_round >= 3, multi_round


def _posterior():
    rs = np.random.RandomState(0)
    n = 12
    X = np.linspace(0, 1, n)[:, None]
    S = np.exp(-((X - X.T) / 0.3) ** 2) + 1e-8 * np.eye(n)
    s2 = 0.05
    f_true = np.linalg.cholesky(S) @ rs.normal(size=n)
    y = f_true + np.sqrt(s2) * rs.normal(size=n)
    P = np.linalg.inv(np.linalg.inv(S) + np.eye(n) / s2)
    mu = P @ (y / s2)
    return S, s2, y, mu, P


def _run_chain(S, s2, y, spec, angles, n_iter=6000):
    n = len(y)
    L = torch.as_tensor(np.linalg.cholesky(S))
    y_t = torch.as_tensor(y)
    gen = torch.Generator().manual_seed(42)

    def log_lik(f):
        return -0.5 * torch.sum((y_t - f) ** 2) / s2

    f = torch.zeros(n, dtype=torch.float64)
    chain = np.empty((n_iter, n))
    for i in range(n_iter):
        nu = L @ torch.randn(n, generator=gen, dtype=torch.float64)
        kw = {}
        if angles:
            def ll_ang(cosv, sinv, f=f, nu=nu):
                c = torch.as_tensor(cosv, dtype=torch.float64)[:, None]
                s = torch.as_tensor(sinv, dtype=torch.float64)[:, None]
                fps = c * f + s * nu
                return -0.5 * torch.sum((y_t - fps) ** 2, dim=1) / s2
            kw['log_lik_angles'] = ll_ang
        f = ess_update(gen, f, nu, log_lik, spec=spec, **kw)
        chain[i] = f.numpy()
    return chain[n_iter // 4:]


@pytest.mark.parametrize("spec,angles", [(1, False), (4, False), (4, True)])
def test_ess_posterior_moments(spec, angles):
    S, s2, y, mu, P = _posterior()
    draws = _run_chain(S, s2, y, spec, angles)
    se = np.sqrt(np.diag(P) / draws.shape[0] * 20)  # autocorr-inflated
    assert np.all(np.abs(draws.mean(0) - mu) < 5 * se + 0.03), (
        np.abs(draws.mean(0) - mu).max())
    np.testing.assert_allclose(draws.var(0), np.diag(P), rtol=0.5, atol=0.02)


def test_no_acceptance_keeps_state():
    """A likelihood that rejects everything leaves f unchanged after the
    step cap, with angle (1, 0)."""
    f = torch.ones(3, dtype=torch.float64)
    nu = torch.zeros(3, dtype=torch.float64)

    def log_lik(fp):
        return torch.tensor(0.0 if torch.equal(fp, f) else -math.inf)

    out, ang = ess_update(torch.Generator().manual_seed(0), f, nu, log_lik,
                          spec=4, max_steps=16, return_angle=True)
    assert torch.equal(out, f) and ang == (1.0, 0.0)
