"""A linked system's training-side prediction operands persist on the
device from one `lgp.predict` call to the next (`kernel.prediction_operands`,
`kernel._op`): the same results bit for bit, nothing made again on a
repeat, exactly the operands whose node attributes were replaced made
again, no tensor in a copy or a pickle of the system, and the operands
freed with it.  The imputations share one copy of a GP container, which a
call predicts once, with the results of a copy for each imputation.  The system is the benchmark cell's at a small size: a
Vecchia gp feeding a Vecchia DGP whose second layer is wired to the global
input, which the linked prediction treats as Gaussian (the dense
`linkgp_prediction_full`)."""
import copy
import gc
import pickle
import weakref

import numpy as np
import pytest
import torch

import dgp_tpu_torch as dt
from dgp_tpu_torch import tracing, utils
from dgp_tpu_torch.models import linkgp
from dgp_tpu_torch.models import node as node_mod
from dgp_tpu_torch.models import ensemble as tens
from dgp_tpu_torch.parallel import mesh as pmesh

X_TEST = np.linspace(-0.9, 0.9, 37)[:, None]


def _system():
    rs = np.random.RandomState(0)
    X1 = rs.uniform(-1, 1, (80, 1))
    Y1 = np.sin(3 * X1) + 0.01 * rs.randn(80, 1)
    X2 = rs.uniform(-1, 1, (60, 1))
    Y2 = np.cos(2 * X2) + 0.02 * rs.randn(60, 1)
    dt.nb_seed(5)
    g = dt.gp(X1, Y1, dt.kernel(length=np.array([0.5]), scale_est=True, nugget=1e-3),
              vecchia=True, m=10, device='cpu')
    k = dt.kernel
    layers = dt.combine([k(length=np.array([0.5]), name='sexp', nugget=1e-2)],
                        [k(length=np.array([0.4]), name='sexp', nugget=1e-2, scale=0.3,
                           connect=np.arange(1))])
    m2 = dt.dgp(X2, Y2, layers, vecchia=True, m=10, device='cpu')
    c1 = dt.container(g.export(), local_input_idx=np.array([0]), device='cpu')
    c2 = dt.container(m2.estimate(), local_input_idx=np.array([0]), device='cpu')
    return dt.lgp([[c1], [c2]], N=3, device='cpu')


def _nodes(system):
    """The system's GP nodes, each once: the imputations share a GP
    container's."""
    return list({id(node): node for one in system.all_layer_set for layer in one
                 for cont in layer for node in linkgp._gp_nodes(cont.structure)}.values())


def _kept(system):
    """(node index, key) -> the operand each node keeps."""
    return {(i, key): op[0] for i, node in enumerate(_nodes(system))
            if node in node_mod._KEPT for key, op in node_mod._KEPT[node].ops.items()}


def _predict(system, **kw):
    """(mean, var) of one call and the counts it made."""
    with tracing.recording() as rec:
        out = system.predict(X_TEST, m=15, **kw)
    return out, rec.counters


def _same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u[0], v[0])


def _remade(before, after):
    """The keys whose operand is not the one kept before."""
    return {k for k, op in after.items() if before.get(k) is not op}


@pytest.fixture(scope="module")
def built():
    """A system predicted on once, and its first call's results."""
    system = _system()
    first, counts = _predict(system)
    assert counts["pred_ops.made"] > 0 and "pred_ops.kept" not in counts
    return system, first


def test_a_repeat_keeps_every_operand_and_gives_the_same_results(built):
    system, first = built
    before = _kept(system)
    again, counts = _predict(system)
    _same(again, first)
    assert "pred_ops.made" not in counts and counts["pred_ops.kept"] > 0
    assert "pred_ops.upload_bytes" not in counts          # nothing made on a card
    assert not _remade(before, _kept(system))
    # the dense node's Rinv is among the kept operands
    assert any(key == 'Rinv' for _, key in before)


def test_the_first_call_equals_a_freshly_built_systems(built):
    system, first = built
    fresh = _system()
    for a, b in zip(_nodes(system), _nodes(fresh)):
        np.testing.assert_array_equal(a.output, b.output)
    _same(_predict(fresh)[0], first)
    _same(_predict(copy.deepcopy(system))[0], first)


def _changed_system(change):
    """A system predicted on once, then ``change(system)``: (its next
    call's results, the counts, the remade keys, a deep copy's results)."""
    system = _system()
    _predict(system)
    change(system)
    before = _kept(system)
    ref = _predict(copy.deepcopy(system))[0]
    out, counts = _predict(system)
    return out, counts, _remade(before, _kept(system)), ref


def _dense_node(system, i=0):
    return system.all_layer_set[i][1][0].structure[1][0]


def _first_node(system, i=0):
    return system.all_layer_set[i][1][0].structure[0][0]


def test_a_new_length_and_its_stats_remake_those_operands_alone():
    def change(system):
        nd = _dense_node(system)
        nd.length = nd.length * 1.3
        nd.compute_stats()
    out, counts, remade, ref = _changed_system(change)
    _same(out, ref)
    names = {key for _, key in remade}
    assert names == {'length', 'Rinv', 'Rinv_y'} and len({n for n, _ in remade}) == 1
    assert counts["pred_ops.made"] == len(remade) == 3


def test_a_replaced_input_remakes_the_operands_made_from_it():
    def change(system):
        nd = _first_node(system, 1)
        nd.input = nd.input + 0.01 * np.sin(5 * nd.input)
    out, counts, remade, ref = _changed_system(change)
    _same(out, ref)
    assert len({n for n, _ in remade}) == 1
    names = {key for _, key in remade}
    assert 'input' in names and all(
        key in ('input', 'X') or key[0] in ('nn', 'input') for key in names)
    assert 'length' not in names and 'y' not in names
    assert counts["pred_ops.made"] == len(remade)


def test_switching_vecchia_off_and_on_matches_a_fresh_copy():
    system = _system()
    first, _ = _predict(system)
    system.set_vecchia(False)
    before = _kept(system)
    dense, counts = _predict(system)
    _same(dense, _predict(copy.deepcopy(system))[0])
    remade = _remade(before, _kept(system))
    # key_stats gave every node new stats: each node's Rinv made again
    assert {(n, 'Rinv') for n in range(len(_nodes(system)))} <= remade
    assert counts["pred_ops.made"] == len(remade)
    system.set_vecchia(True)
    before = _kept(system)
    back, counts = _predict(system)
    _same(back, _predict(copy.deepcopy(system))[0])
    assert not _remade(before, _kept(system)) and "pred_ops.made" not in counts
    _same(back, first)


@pytest.mark.parametrize("method", ["mean_var", "sampling"])
def test_the_imputations_share_one_gp_container_predicted_once(method):
    system = _system()
    conts = [one[0][0] for one in system.all_layer_set]
    assert all(c is conts[0] for c in conts) and conts[0] is not system.all_layer[0][0]
    apart = copy.copy(system)           # a copy of the GP container for each imputation
    apart.all_layer_set = [[[copy.deepcopy(c) if c.type == 'gp' else c for c in layer]
                            for layer in one] for one in system.all_layer_set]
    outs, krigings = [], []
    for s in (system, apart):
        np.random.seed(7)
        with tracing.recording() as rec:
            outs.append(s.predict(X_TEST, m=15, method=method, sample_size=4))
        krigings.append(sum(sp.name == "predict.kriging" for sp in rec.spans))
    assert krigings == [1, len(conts)]
    for a, b in zip(*[o if method == 'mean_var' else (o,) for o in outs]):
        np.testing.assert_array_equal(a[0], b[0])


def _tensors(obj):
    """The tensors reachable from ``obj`` other than through the engines'
    caches, which `write` leaves out (`utils._CACHES`)."""
    seen, stack, found = set(), [obj], []
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            found.append(o)
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif hasattr(o, '__dict__') and not isinstance(o, type):
            stack.extend(v for k, v in vars(o).items() if k not in utils._CACHES)
    return found


def test_copies_and_pickles_of_a_predicted_system_hold_no_tensor(built, tmp_path):
    system, first = built
    for obj in (system, system.all_layer_set[0][1][0], _dense_node(system)):
        assert not _tensors(obj)
        cp = copy.deepcopy(obj)
        assert not _tensors(cp)
        assert not any(n in node_mod._KEPT for n in utils._walk(cp)
                       if isinstance(n, node_mod.kernel))
        dt.write(obj, str(tmp_path / "o"))
        assert not _tensors(dt.read(str(tmp_path / "o"), device='cpu'))
    utils._Pickler(open(tmp_path / "n.pkl", "wb")).dump(_dense_node(system))
    assert not _tensors(pickle.loads((tmp_path / "n.pkl").read_bytes()))
    dt.write(system, str(tmp_path / "lgp"))
    _same(_predict(dt.read(str(tmp_path / "lgp"), device='cpu'))[0], first)


def test_the_operands_are_freed_with_the_system():
    system = _system()
    _predict(system)
    refs = [weakref.ref(n) for n in _nodes(system)]
    assert all(r() in node_mod._KEPT for r in refs)
    ops = [weakref.ref(op) for op in _kept(system).values() if isinstance(op, torch.Tensor)]
    assert ops
    del system
    gc.collect()
    assert all(r() is None for r in refs + ops)


def test_outside_lgp_operands_are_made_on_every_call(built):
    system, _ = built
    nd = _dense_node(system)
    kept = dict(node_mod._KEPT[nd].ops)
    x = np.linspace(-1, 1, 5)[:, None]
    with tracing.recording() as rec:
        a = nd.gp_prediction(x, x)
    with tracing.recording() as rec2:
        b = nd.gp_prediction(x, x)
    _same(a, b)
    assert "pred_ops.kept" not in rec.counters and "pred_ops.kept" not in rec2.counters
    assert rec.counters["pred_ops.made"] == rec2.counters["pred_ops.made"] > 0
    assert {k: v[0] for k, v in node_mod._KEPT[nd].ops.items()} == {
        k: v[0] for k, v in kept.items()}


@pytest.mark.parametrize("shares", [1, 2])
def test_sharded_prediction_equals_the_plain_call(built, shares, monkeypatch):
    system, first = built
    monkeypatch.setattr(pmesh, 'model_mesh', lambda device: (torch.device('cpu'),) * shares)
    monkeypatch.setattr(tens, '_CHUNK', 8)
    plain, _ = _predict(system)
    for out in (_predict(system, sharded=True)[0], system.ppredict(X_TEST, m=15)):
        _same(out, plain)
