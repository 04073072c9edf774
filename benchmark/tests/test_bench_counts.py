"""The frozen operation and byte counts against counts made by hand at
small shapes, and the least time they give."""
import json

import pytest
import torch

from benchmark.counts import ops
from conftest import ROOT


def t(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def chol_by_hand(m1):
    """Column Cholesky of an m1 x m1 block, counted column by column: the
    pivot (its squares' sum and a square root: 2j + 1), then each row below
    it (a dot of j terms, a subtraction and a division: 2j + 2)."""
    total = 0
    for j in range(m1):
        total += 2 * j + 1
        total += (m1 - 1 - j) * (2 * j + 2)
    return total


def test_cholesky_count():
    assert [chol_by_hand(m) for m in (1, 2, 3)] == [1, 6, 17]
    assert ops._chol(3) == 17 and ops._chol(26) == chol_by_hand(26)


def test_k3_by_hand():
    # m1 = 3, d = 1, n = 2: 3 pairs of 3d + 1 = 4, the factor's 17, the
    # (m1 - 1)^2 = 4 of the weights' solve: 33 a point
    o, b = ops.k3((t(3, 1, 2), t(3, 2)), {})
    assert o == 2 * 33
    assert b == (6 + 6 + 3 * 2) * 8


def test_k2_static_dims_once_a_point():
    # m1 = 2, d = 2, n = 1, K = 3, dl = 1: a pair; per candidate 4*m1*dl +
    # pairs*(3*dl + 1) + pairs (times the static factor) = 8 + 4 + 1, the
    # factor 6, the solve 4; once a point the static pair 3*1 + 1 = 4
    args = (t(2, 2, 1), t(2, 2, 1), t(2, 2, 1), t(2, 1), t(2, 1), t(3), t(3))
    o, b = ops.k2(args, {"dl": 1})
    assert o == 3 * (13 + 6 + 4) + 4
    assert b == (4 * 3 + 2 * 2 + 2 * 3 + 2 * 3) * 8
    o0, _ = ops.k2(args, {"dl": 0})                  # every dim per candidate
    assert o0 == 3 * (4 * 2 * 2 + 1 * 7 + 6 + 4)


def test_k1_takes_the_fewer_gradient_operations():
    # m1 = 2, d = 1, n = 1, one length lane, nugget estimated (p = 2)
    args = (t(2, 1, 1), t(2, 1), t(2, 1), t(2, 1))
    o, b = ops.k1(args, {"n_length": 1, "nugget_est": True})
    forward = 1 * 1 * 6 + 2 + 2 * (4 + 4 + 4)
    forms = 4 + 1 * 12 + 4 + 8 + 8
    assert o == 1 * 4 + 6 + 8 + min(forward, forms)
    assert b == (2 + 2 + 2 + 2 + 2 + 4) * 8


def test_dense_linked_by_hand():
    # M = 1 query, D = 1, n = 2: I 2*(5 + 2), J 4*(8 + 2), trace and forms 4*4 + 4*2
    args = (t(1, 1), t(1, 1), None, t(2, 1), None, t(2, 2), t(2))
    o, _ = ops.linkgp_dense(args, {})
    assert o == 14 + 40 + 16 + 8


def test_least_time_is_the_larger_bound():
    peaks = json.loads((ROOT / "benchmark" / "counts" / "peaks.json").read_text())
    assert ops.least_seconds(67e12, 0, peaks) == pytest.approx(1.0)
    assert ops.least_seconds(0, 3.35e12, peaks) == pytest.approx(1.0)
    assert ops.least_seconds(67e12, 6.7e12, peaks) == pytest.approx(2.0)
