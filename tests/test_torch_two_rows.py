"""The plain versions of K2, K3 and K4 at the blocks that the kernels take
with two rows per lane (33 <= m1 <= 64), against their Pallas kernels in
interpret mode on the same float64 inputs, at m1 = 33 (both correlation
kernels), 41 (Matern-2.5) and 64 (sexp): the interpret mode's trace grows
with m1, and one case at m1 = 64 takes up to a minute on the CPU.  K1 is in
tests/test_torch_grad_lanes.py.  Tolerances as in
tests/test_torch_vecchia.py: rtol 1e-9, atol 1e-12."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgp_tpu.ops import pallas_vecchia as pv
from dgp_tpu_torch.ops import cuda_vecchia as cv
from test_torch_vecchia import _close, _edge_blocks, _jit, _multi_inputs, _t

torch.set_num_threads(1)

# (m1, name): each m1 of the two-rows-per-lane range once or twice
ROWS = dict(argvalues=[(33, "sexp"), (33, "matern2.5"), (41, "matern2.5"), (64, "sexp")],
            ids=["m33-sexp", "m33-matern2.5", "m41-matern2.5", "m64-sexp"])


@pytest.mark.parametrize("m1,name", **ROWS)
def test_block_loglik_multi_two_rows_matches_pallas(m1, name):
    """K2's plain version against the Pallas kernel: one dim from the
    candidates, one static, three candidates."""
    args = _multi_inputs(1, 1, m1=m1, n=m1 + 40, K=3)
    ld_t, q_t = cv.block_loglik_multi_t(*(_t(a) for a in args), name=name, dl=1)
    ld_j, q_j = pv.block_loglik_multi_t(*(jnp.asarray(a) for a in args), name=name, dl=1)
    _close(ld_t, ld_j)
    _close(q_t, q_j)
    assert cv.launch_counts()["block_loglik_multi_t"]["launches"] == 0  # CPU: plain version


@pytest.mark.parametrize("m1,name", **ROWS)
def test_cond_weights_two_rows_matches_pallas(m1, name):
    """K3's plain version against the Pallas kernel on blocks from a real
    neighbour structure (its first rows have sentinel lanes)."""
    Xg, _, diag = _edge_blocks(m1 + 40, m1 - 1, 2, seed=12)
    w_t, s_t = cv.cond_weights_t(_t(Xg), _t(diag), name=name)
    w_j, s_j = _jit(pv.cond_weights_t, 'name')(jnp.asarray(Xg), jnp.asarray(diag), name=name)
    assert w_t.shape == (m1 - 1, m1 + 40)
    _close(w_t, w_j)
    _close(s_t, s_j)
    assert cv.launch_counts()["cond_weights_t"]["launches"] == 0


@pytest.mark.parametrize("m1,name", **ROWS)
def test_block_loglik_parts_two_rows_matches_pallas(m1, name):
    """K4's plain version against the Pallas kernel, alone and with a
    leading axis of two candidates that each bring their own targets and
    diagonal."""
    cands = [_edge_blocks(m1 + 40, m1 - 1, 2, seed=13 + k, nugget=1e-3 * (1 + k))
             for k in range(2)]
    ref = _jit(pv.block_loglik_parts_t, 'name')
    refs = [ref(*(jnp.asarray(a) for a in b), name=name) for b in cands]
    one = cv.block_loglik_parts_t(*(_t(a) for a in cands[0]), name=name)
    _close(one[0], refs[0][0])
    _close(one[1], refs[0][1])
    out = cv.block_loglik_parts_t(*[_t(np.stack([b[i] for b in cands])) for i in range(3)],
                                  name=name)
    for c, r in enumerate(refs):
        _close(out[0][c], r[0])
        _close(out[1][c], r[1])
    assert cv.launch_counts()["block_loglik_parts_t"]["launches"] == 0
