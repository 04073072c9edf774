"""The traffic repeats for a seed: the same seed gives the same data,
request sizes, points and judged units; another seed the same sizes in
another order."""
import numpy as np
import pytest

from benchmark.harness import core, data
from benchmark.traffic import predict


def make_run(cell, seed):
    spec, cfg, mix = core.cell_files(cell)
    return core.Run(cell, spec, cfg, mix, seed, 30, 0, "cpu", "float64")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_sub_seeds_repeat_and_fit_every_generator(seed):
    a, b = core.sub_seed(seed, "data"), core.sub_seed(seed, "data")
    assert a == b and 0 <= a < 2**31 and a != core.sub_seed(seed, "model")
    np.random.RandomState(a)


def test_data_repeat_for_a_seed():
    run1, run2 = make_run("vsi_n1e5.sem", 2**31 + 11), make_run("vsi_n1e5.sem", 2**31 + 11)
    spec = dict(run1.config["data"], n=500)
    X1, Y1 = data.design(run1.rng("data"), spec)
    X2, Y2 = data.design(run2.rng("data"), spec)
    assert np.array_equal(X1, X2) and np.array_equal(Y1, Y2)
    X3, _ = data.design(make_run("vsi_n1e5.sem", 3).rng("data"), spec)
    assert not np.array_equal(X1, X3)


def test_request_sizes_are_one_set_in_each_seeds_order():
    a = predict.request_sizes(make_run("vsi_n1e5.predict", 1))
    b = predict.request_sizes(make_run("vsi_n1e5.predict", 1))
    c = predict.request_sizes(make_run("vsi_n1e5.predict", 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert sorted(a) == sorted(c) and a.min() == 1000 and a.max() == 8000


@pytest.mark.parametrize("cell", ["vsi_n1e5.sem", "lgp_n2000.predict", "vsi_n1e5.predict"])
def test_judged_units_repeat_and_hold_the_first(cell):
    run = make_run(cell, 2**31 + 99)
    units = run.checked_units()
    assert units == make_run(cell, 2**31 + 99).checked_units()
    assert 0 in units and len(units) == run.spec["check_units"]
    assert max(units) < run.spec["check_from"]
