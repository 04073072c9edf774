"""The serving slice as a whole, dgp_tpu_torch against dgp_tpu, at n=200,
m=10 (a 2-layer Vecchia DGP shaped like bench.py's: sexp, layer 2 wired to
the global input):

1. for the same state, f, nu and angles, the port's angle evaluator
   (`_plan_ll`, through the plain version of the K2 kernel) equals the JAX
   package's `_upper_loglik` evaluated on each candidate;
2. a JAX emulator's imputation set, carried across with `interop`, predicts
   the same mean and variance in the port;
3. with the same data, hyper-parameters and seeds, the port's emulator RMSE
   lies inside the JAX package's own seed spread;
4. importing dgp_tpu_torch does not import jax.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dgp_tpu
import dgp_tpu_torch
from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
from dgp_tpu_torch.models.compiled import CompiledDGP, _Shares

torch.set_num_threads(1)

N, M_NN, PRED_M = 200, 10, 20


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def _data():
    rs = np.random.RandomState(0)
    X = rs.rand(N, 1) * 2 - 1
    return X, func(X) + 0.05 * rs.randn(N, 1)


def _layers(pkg):
    l1 = [pkg.kernel(length=np.array([0.2]), nugget=1e-4)]
    l2 = [pkg.kernel(length=np.array([0.3]), nugget=1e-2, scale=0.5,
                     nugget_est=True, scale_est=True, connect=np.arange(1))]
    return pkg.combine(l1, l2)


def _rmse(pkg, seed, z, **kw):
    X, Y = _data()
    pkg.nb_seed(seed)
    m = pkg.dgp(X, Y, _layers(pkg), vecchia=True, m=M_NN, **kw)
    mu, _ = pkg.emulator(m.estimate(), N=5, **kw).predict(z, m=PRED_M)
    return float(np.sqrt(np.mean((mu - func(z)) ** 2)))


@pytest.fixture(scope="module")
def jax_model():
    X, Y = _data()
    dgp_tpu.nb_seed(0)
    return dgp_tpu.dgp(X, Y, _layers(dgp_tpu), vecchia=True, m=M_NN)


def test_plan_ll_equals_upper_loglik(jax_model):
    eng_j = jax_model.imp._engine()
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state()
    eng_t = CompiledDGP(layers_from_numpy(layers_to_numpy(jax_model.all_layer)),
                        device='cpu')
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    np.testing.assert_array_equal(lat_t[0].numpy(), np.asarray(lat_j[0]))
    shares = _Shares(eng_t, nn_t)
    shares.sync(lat_t, par_t)
    nu = np.random.RandomState(1).normal(size=(N, 1)) * 0.5
    nu_t = torch.as_tensor(nu)
    ang = np.concatenate([[0.0], np.random.RandomState(2).uniform(0, 2 * np.pi, 8)])
    f = np.asarray(lat_j[0])
    upper = jax.jit(lambda lat: eng_j._upper_loglik(0, (lat,), par_j, nn_j))
    ref = [float(upper(jnp.asarray(np.cos(a) * f + np.sin(a) * nu))) for a in ang]
    # nu views gathered per sweep, and batched ahead through pre_nu
    for pre_nu in (None, {(0, 0): nu_t[None, :, 0]}):
        plan = eng_t._build_angle_plan(0, lat_t, par_t, shares.items[0], pre_nu, 1)
        A = [nd['A0'] for nd in plan['nodes']]
        B = [nd['B_all'][0] if nd['B_all'] is not None
             else eng_t._gather_latent_view(nd, nu_t) for nd in plan['nodes']]
        ll = eng_t._plan_ll([plan], 0, lat_t, nu_t, [A], [B], shares)
        np.testing.assert_allclose(ll(np.cos(ang).tolist(), np.sin(ang).tolist()).numpy(),
                                   ref, rtol=1e-9)


def test_carried_imputations_predict_the_same(jax_model):
    emu_j = dgp_tpu.emulator(jax_model.estimate(), N=2)
    z = np.linspace(-1, 1, 150).reshape(-1, 1)
    mu_j, var_j = emu_j.predict(z, m=PRED_M)
    emu_t = dgp_tpu_torch.emulator.from_imputations(
        [layers_from_numpy(layers_to_numpy(s)) for s in emu_j.all_layer_set],
        device='cpu')
    mu_t, var_t = emu_t.predict(z, m=PRED_M)
    # Same imputations, the same exact-NN conditioning sets, float64
    # factorisations of (m+1)-blocks in another order (torch.linalg vs the
    # unrolled JAX form) and the linked layer's moment algebra: agreement
    # to rounding, amplified by block conditioning (~1e4 at nugget 1e-4).
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var_t, var_j, rtol=1e-8, atol=1e-10)


#: RMSE of the JAX package's emulator under this file's protocol
#: (_rmse(dgp_tpu, seed, z)), seeds 0-9 on the CPU, with dgp_tpu as of
#: commit 5700fd6 (its last change); running it here would cost ~20 s per
#: seed, so the spread is recorded
JAX_SEED_RMSE = (0.15142059222441456, 0.13896593927583048, 0.14923366165232668,
                 0.13088462599162634, 0.17194294698307208, 0.14422950409246207,
                 0.18080632776902283, 0.12587296202233153, 0.1405192315523264,
                 0.16968815792171235)


def test_emulator_rmse_within_jax_seed_spread():
    z = np.linspace(-1, 1, 300).reshape(-1, 1)
    # The random streams differ between the packages, so the RMSE can only
    # agree in distribution.  Two-sided bound on every seed: from the JAX
    # package's best seed less two standard deviations of its seed spread
    # (JAX_SEED_RMSE) to its worst seed plus two.
    spread = np.asarray(JAX_SEED_RMSE)
    lo, hi = spread.min() - 2 * spread.std(), spread.max() + 2 * spread.std()
    rmse = [_rmse(dgp_tpu_torch, seed, z, device='cpu') for seed in range(3)]
    assert all(np.isfinite(rmse)), rmse
    assert lo <= min(rmse) and max(rmse) <= hi, (rmse, lo, hi)


def test_import_leaves_jax_out():
    code = ("import sys; pre = 'jax' in sys.modules; import dgp_tpu_torch; "
            "sys.exit(0 if pre or 'jax' not in sys.modules else 1)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=Path(dgp_tpu_torch.__file__).parent.parent)
    assert res.returncode == 0, res.stderr
    pkg = Path(dgp_tpu_torch.__file__).parent
    for src in pkg.rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
