"""The facades of dgp_tpu_torch against dgp_tpu, in float64 on the CPU:
`dgp.update_xy` on a dgp carried across with `interop.dgp_from_numpy` (the
subset, superset, reset and new-data paths, with both packages' imputers'
draws left out), `dgp.to_vecchia` / `remove_vecchia`, `dgp_from_numpy`
itself (`estimate` and the engine's log-likelihoods), `write` / `read`,
`summary`'s cells, prior paths (`path`), `read_dgpsi` on a checkpoint whose
classes are stand-ins registered under ``dgpsi.*`` and then removed, and the
package's public names and imports.

Tolerances: rtol 1e-9 wherever a value is computed (conditional means,
log-likelihoods, predictions, prior paths), with an absolute floor of 1e-9
on values of order 1; orderings and neighbours equal."""
import copy
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import torch

import dgp_tpu
from dgp_tpu.models import imputation as jimp
import dgp_tpu_torch
from dgp_tpu_torch import utils as tutils
from dgp_tpu_torch.interop import (dgp_from_numpy, gp_from_numpy, layers_from_numpy,
                                   layers_to_numpy, lgp_from_numpy)
from dgp_tpu_torch.models import imputation as timp
from test_torch_design import _emulators, _jax_model
from test_torch_linked import _system

TOL = dict(rtol=1e-9, atol=1e-9)
NODE_ARRAYS = ('input', 'output', 'global_input', 'ord', 'NNarray', 'W_diag', 'rep')


def _no_draws(monkeypatch):
    monkeypatch.setattr(jimp.imputer, 'sample', lambda self, burnin=0: None)
    monkeypatch.setattr(timp.imputer, 'sample', lambda self, burnin=0: None)


def _same_state(mt, mj):
    assert mt.m == mj.m and mt.n_data == mj.n_data
    np.testing.assert_array_equal(mt.X, mj.X)
    for a, b in ((mt.indices, mj.indices), (mt.Y, mj.Y)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for lt, lj in zip(mt.all_layer, mj.all_layer):
        for nt, nj in zip(lt, lj):
            for key in NODE_ARRAYS:
                a, b = getattr(nt, key, None), getattr(nj, key, None)
                assert (a is None) == (b is None), key
                if a is None:
                    continue
                if key in ('ord', 'NNarray', 'rep'):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    np.testing.assert_allclose(a, b, err_msg=key, **TOL)
            if nt.type == 'gp':
                assert nt.m == nj.m and nt.vecch == nj.vecch


def _new_data(case, X, Y, rep):
    rs = np.random.RandomState(8)
    if case == 'subset':
        keep = np.sort(rs.choice(len(X), len(X) - 8, replace=False))
        return X[keep], Y[keep]
    extra = rs.rand(6, X.shape[1])
    if rep:
        extra = np.concatenate([extra, extra[:2]])
    y_extra = (rs.poisson(3.0, (len(extra), 1)).astype(float) if rep
               else np.sin(3 * extra[:, :1]) + 0.05 * rs.randn(len(extra), 1))
    if case == 'other':
        return rs.rand(*X.shape), Y
    return np.concatenate([X, extra]), np.concatenate([Y, y_extra])


UPDATES = [('gp', True, False, 'subset'), ('gp', True, False, 'superset'),
           ('gp', True, False, 'reset'), ('gp', True, False, 'other'),
           ('gp', False, False, 'superset'), ('pois', True, True, 'subset'),
           ('pois', True, True, 'superset')]


@pytest.mark.parametrize("kind,vecchia,rep,case", UPDATES)
def test_update_xy_matches_jax(kind, vecchia, rep, case, monkeypatch):
    """Latents, inputs, global inputs, orderings and neighbours after
    update_xy, with both imputers' draws left out: new points' latents are
    each node's conditional mean, the Vecchia nodes re-wired at the new n
    from the same numpy seed."""
    model, X, Y = _jax_model(kind, vecchia, rep)
    mj = copy.deepcopy(model)
    mt = dgp_from_numpy(model, device='cpu')
    _same_state(mt, mj)
    X2, Y2 = _new_data(case, X, Y, rep)
    _no_draws(monkeypatch)
    for m in (mj, mt):
        np.random.seed(7)
        m.update_xy(X2, Y2, reset=case == 'reset')
    _same_state(mt, mj)
    assert mt.n_data == len(np.unique(X2, axis=0))
    assert mt.imp.all_layer is mt.all_layer and mt.imp.device == mt.device


@pytest.mark.parametrize("vecchia", [True, False])
def test_update_xy_then_train(vecchia):
    """One update_xy with its burn-in draws, then two SEM iterations:
    finite estimates at the new n."""
    model, X, Y = _jax_model('gp', vecchia, False)
    mt = dgp_from_numpy(model, device='cpu')
    X2, Y2 = _new_data('superset', X, Y, False)
    dgp_tpu_torch.nb_seed(3)
    mt.update_xy(X2, Y2)
    mt.train(N=2, disable=True)
    est = mt.estimate()
    assert mt.N == 2 and mt.all_layer[0][0].input.shape[0] == len(X2)
    assert all(np.isfinite(nd.output).all() and np.isfinite(nd.scale).all()
               and np.isfinite(nd.length).all() for layer in est for nd in layer)


def test_dgp_vecchia_switches_match_jax(monkeypatch):
    """to_vecchia: the orderings and neighbours of the JAX package from the
    same numpy seed, a new imputer; remove_vecchia: dense nodes again."""
    model, _, _ = _jax_model('gp', False, False)
    mj = copy.deepcopy(model)
    mt = dgp_from_numpy(model, device='cpu')
    eng = mt.imp._engine()
    for m in (mj, mt):
        np.random.seed(9)
        m.to_vecchia(m=6)
    _same_state(mt, mj)
    assert mt.vecch and mt.m == 6 and mt.imp._compiled is None
    assert all(nd.NNarray.shape == (len(mt.X), 7) for layer in mt.all_layer for nd in layer)
    with pytest.raises(Exception, match="already in Vecchia"):
        mt.to_vecchia()
    assert mt.imp._engine() is not eng and mt.imp._engine().spec[0][0].vecch
    for m in (mj, mt):
        m.remove_vecchia()
    assert not mt.vecch and not any(nd.vecch for layer in mt.all_layer for nd in layer)
    assert not mt.imp._engine().spec[0][0].vecch
    with pytest.raises(Exception, match="non-Vecchia"):
        mt.remove_vecchia()


def test_update_all_layer_replaces_the_engine(monkeypatch):
    model, _, _ = _jax_model('gp', True, False)
    mt = dgp_from_numpy(model, device='cpu')
    eng = mt.imp._engine()
    _no_draws(monkeypatch)
    mt.update_all_layer(layers_from_numpy(layers_to_numpy(model.all_layer)))
    assert mt.imp._engine() is not eng and mt.N == 0 and mt.vecch
    assert all(nd.device == mt.device and len(nd.para_path) == 1
               for layer in mt.all_layer for nd in layer)


@pytest.mark.parametrize("kind,vecchia,rep", [('gp', True, False), ('gp', False, False),
                                              ('pois', True, True)])
def test_dgp_from_numpy_estimate_and_loglik(kind, vecchia, rep):
    """A carried dgp estimates what the JAX one does, and its engine gives
    the JAX engine's upper log-likelihood of every hidden layer."""
    model, _, _ = _jax_model(kind, vecchia, rep)
    mj = copy.deepcopy(model)
    rs = np.random.RandomState(2)
    for layer in mj.all_layer:
        for nd in layer:
            if nd.type == 'gp':
                nd.para_path = np.vstack([nd.para_path] + [
                    nd.para_path[0] * rs.uniform(0.8, 1.2, nd.para_path.shape[1])
                    for _ in range(4)])
    mj.N = 4
    mt = dgp_from_numpy(mj, device='cpu')
    for lt, lj in zip(mt.estimate(), mj.estimate()):
        for nt, nj in zip(lt, lj):
            if nt.type == 'gp':
                for key in ('scale', 'length', 'nugget'):
                    np.testing.assert_allclose(getattr(nt, key), getattr(nj, key), rtol=1e-12)
    assert (mt.N, mt.burnin, mt.block, mt.nn_method) == (mj.N, mj.burnin, mj.block,
                                                         mj.nn_method)
    eng_j = dgp_tpu.models.compiled.CompiledDGP(mj.all_layer)
    eng_t = mt.imp._engine()
    lat_j, par_j = eng_j.get_state()
    nn_j = eng_j.get_nn_state() if vecchia else eng_j._empty_nn()
    lat_t, par_t = eng_t.get_state()
    nn_t = eng_t.get_nn_state()
    for l in range(mt.n_layer - 1):
        ref = float(jax.jit(lambda lat, l=l: eng_j._upper_loglik(l, lat, par_j, nn_j))(lat_j))
        np.testing.assert_allclose(float(eng_t._upper_loglik(l, lat_t, par_t, nn_t)), ref,
                                   rtol=1e-9)


# ----------------------------------------------------------------------
# write / read
# ----------------------------------------------------------------------
def _globals(path):
    """The (module, name) pairs a pickle file refers to."""
    found = []

    class Rec(pickle.Unpickler):
        def find_class(self, module, name):
            found.append((module, name))
            return super().find_class(module, name)
    with open(path, 'rb') as f:
        Rec(f).load()
    return found


def _objects():
    """(name, port object, its predict function) for each kind `write`
    takes."""
    X = np.linspace(0, 1, 25)[:, None]
    g = dgp_tpu_torch.gp(X, np.sin(5 * X), dgp_tpu_torch.kernel(
        length=np.array([0.3]), scale_est=True, nugget_est=True), device='cpu')
    g.train()
    model, _, _ = _jax_model('gp', True, False)
    m = dgp_from_numpy(model, device='cpu')
    m.imp._engine()
    _, emu, _, _, _ = _emulators('cat', True)
    system, xt = _system("gp-dense-dgp")
    z1 = np.linspace(0.05, 0.95, 9)[:, None]
    z2 = np.random.RandomState(1).rand(9, 2)
    port_system = lgp_from_numpy(system, device='cpu')
    for cont in (c for one in port_system.all_layer_set for layer in one for c in layer):
        if cont.type == 'dgp':
            cont.imp._engine()
    return [('gp', g, lambda o: o.predict(z1)),
            ('dgp', m, lambda o: o.imp._engine()._upper_loglik(
                0, *[o.imp._engine().get_state()[i] for i in (0, 1)],
                o.imp._engine().get_nn_state()).numpy()),
            ('emulator', emu, lambda o: o.predict(z1, m=10, full_layer=True)),
            ('lgp', port_system, lambda o: o.predict(xt)),
            ('emulator-2d', _emulators('gp', False)[1], lambda o: o.loo(z2))]


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_write_read_round_trip(tmp_path):
    """Predictions after read equal those before, bit for bit; the file
    refers to no tensor; the caches stripped for pickling come back."""
    for name, obj, pred in _objects():
        before = pred(obj)
        caches = [(o, a, o.__dict__[a]) for o in tutils._walk(obj) for a in tutils._CACHES
                  if o.__dict__.get(a) is not None]
        assert caches or name == 'gp'
        path = str(tmp_path / name)
        dgp_tpu_torch.write(obj, path)
        assert all(o.__dict__[a] is c for o, a, c in caches)
        refs = _globals(path + '.pkl')
        assert not [r for r in refs if r[0].startswith('torch') and r != ('torch', 'device')]
        back = dgp_tpu_torch.read(path, device='cpu')
        assert type(back) is type(obj)
        _equal(pred(back), before)
        assert all(o.device == torch.device('cpu') for o in tutils._walk(back)
                   if 'device' in o.__dict__)


def test_read_puts_a_card_written_file_on_the_cpu(tmp_path):
    """A file whose objects name a CUDA device loads with device='cpu' and
    predicts as before."""
    _, emu, _, _, _ = _emulators('gp', True)
    z = np.linspace(0.1, 0.9, 7)[:, None].repeat(2, axis=1)
    before = emu.predict(z, m=10)
    card = copy.deepcopy(emu)
    for o in tutils._walk(card):
        if 'device' in o.__dict__:
            o.device = torch.device('cuda', 0)
    dgp_tpu_torch.write(card, str(tmp_path / 'card'))
    assert card.device == torch.device('cuda', 0)
    _equal(dgp_tpu_torch.read(str(tmp_path / 'card'), device='cpu').predict(z, m=10), before)
    with pytest.raises(TypeError, match="torch.Tensor"):
        card.bad = torch.zeros(1)
        dgp_tpu_torch.write(card, str(tmp_path / 'bad'))


# ----------------------------------------------------------------------
# summary, thread shims
# ----------------------------------------------------------------------
def _jax_rows(obj, monkeypatch):
    rows = []
    monkeypatch.setattr(dgp_tpu.utils, 'tabulate',
                        lambda info, **kw: rows.append(info) or '')
    dgp_tpu.summary(obj)
    return rows[0]


def test_summary_cells_match_jax(monkeypatch, capsys):
    model, _, _ = _jax_model('gp', True, False)
    emu_j, emu_t, _, _, _ = _emulators('cat', False)
    system, _ = _system("gp-dense-dgp")
    X = np.linspace(0, 1, 12)[:, None]
    k = dict(length=np.array([0.3, 0.5]), scale_est=True, input_dim=np.array([0]),
             connect=np.array([1]))
    gj = dgp_tpu.gp(np.hstack([X, X ** 2]), np.sin(X), dgp_tpu.kernel(**k))
    pairs = [(model.all_layer[0][0], layers_from_numpy(layers_to_numpy(model.all_layer))[0][0]),
             (gj, gp_from_numpy(gj, device='cpu')), (model, dgp_from_numpy(model, device='cpu')),
             (emu_j, emu_t), (system, lgp_from_numpy(system, device='cpu'))]
    for obj_j, obj_t in pairs:
        ref = _jax_rows(obj_j, monkeypatch)
        rows, notes = tutils.summary_rows(obj_t)
        assert rows == ref
        capsys.readouterr()
        dgp_tpu_torch.summary(obj_t)
        out = capsys.readouterr().out
        assert all(line in out for row in rows for cell in row
                   for line in str(cell).split('\n')) and all(n in out for n in notes)
    trained = dgp_from_numpy(model, device='cpu')
    trained.N = 3
    dgp_tpu_torch.summary(trained)
    assert 'construct an emulator()' in capsys.readouterr().out
    with pytest.raises(ValueError, match="tablefmt"):
        dgp_tpu_torch.summary(emu_t, tablefmt='latex')
    dgp_tpu_torch.summary(emu_t, tablefmt='grid')
    assert capsys.readouterr().out.startswith('+-')


def test_thread_shims():
    before = dgp_tpu_torch.get_thread()
    dgp_tpu_torch.set_thread(4)
    assert dgp_tpu_torch.get_thread() == 4
    dgp_tpu_torch.set_thread(before)


# ----------------------------------------------------------------------
# path
# ----------------------------------------------------------------------
def test_path_matches_jax():
    X = np.linspace(0, 1, 15)[:, None]

    def layers(pkg):
        return pkg.combine([pkg.kernel(length=np.array([0.3]), nugget=1e-4)],
                           [pkg.kernel(length=np.array([0.5]), nugget=1e-4, scale=2.0,
                                       connect=np.arange(1))])
    np.random.seed(4)
    ref = dgp_tpu.path(X, layers(dgp_tpu)).generate(3)
    np.random.seed(4)
    out = dgp_tpu_torch.path(X, layers(dgp_tpu_torch), device='cpu').generate(3)
    assert out.shape == (1, 3, 15)
    np.testing.assert_allclose(out, ref, **TOL)


# ----------------------------------------------------------------------
# read_dgpsi
# ----------------------------------------------------------------------
def _stand_ins():
    """Classes named as dgpsi's, registered under ``dgpsi.*`` modules."""
    mods = {'dgpsi': types.ModuleType('dgpsi')}
    mods['dgpsi'].__path__ = []
    for mod, names in (('dgpsi.kernel_class', ('kernel',)), ('dgpsi.gp', ('gp',)),
                       ('dgpsi.dgp', ('dgp',)), ('dgpsi.emulation', ('emulator',))):
        m = types.ModuleType(mod)
        for n in names:
            setattr(m, n, type(n, (), {'__module__': mod}))
        mods[mod] = m
    return mods


def _as_stand_in(obj, cls):
    new = cls.__new__(cls)
    new.__dict__.update(obj.__dict__)
    return new


def test_read_dgpsi_stand_ins(tmp_path, monkeypatch):
    """A checkpoint pickled by reference from stand-ins of dgpsi's gp and
    emulator, read with dgpsi absent: both packages' objects predict the
    same."""
    mods = _stand_ins()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    kcls = mods['dgpsi.kernel_class'].kernel
    # noisy outputs: the trained nugget is 2.8e-3; on noiseless sin(4x) it
    # falls to 1.1e-8, and the two packages' dense variances of ~1e-7 then
    # differ by up to 3.6e-8 (the round-off of a solve at that conditioning)
    X = np.linspace(0, 1, 20)[:, None]
    Yg = np.sin(4 * X) + 0.05 * np.random.RandomState(3).randn(20, 1)
    gj = dgp_tpu.gp(X, Yg, dgp_tpu.kernel(length=np.array([0.3]), name='matern2.5',
                                                     scale_est=True, nugget_est=True))
    gj.train()
    g_stub = _as_stand_in(gj, mods['dgpsi.gp'].gp)
    g_stub.kernel = _as_stand_in(gj.kernel, kcls)
    emu_j, _, _, _, _ = _emulators('gp', False)
    e_stub = mods['dgpsi.emulation'].emulator()
    e_stub.all_layer = [[_as_stand_in(nd, kcls) for nd in layer] for layer in emu_j.all_layer]
    e_stub.all_layer_set = [[[_as_stand_in(nd, kcls) for nd in layer] for layer in one]
                            for one in emu_j.all_layer_set]
    for name, stub in (('g', g_stub), ('e', e_stub)):
        with open(tmp_path / f'{name}.pkl', 'wb') as f:
            pickle.dump(stub, f)
    for name in mods:
        monkeypatch.delitem(sys.modules, name)
    z1 = np.linspace(-0.1, 1.1, 17)[:, None]
    z2 = np.random.RandomState(2).rand(11, 2)
    gt = dgp_tpu_torch.read_dgpsi(str(tmp_path / 'g'), device='cpu')
    assert type(gt) is dgp_tpu_torch.gp and gt.kernel.device == torch.device('cpu')
    _close_all(gt.predict(z1), dgp_tpu.read_dgpsi(str(tmp_path / 'g')).predict(z1))
    et = dgp_tpu_torch.read_dgpsi(str(tmp_path / 'e.pkl'), device='cpu')
    assert type(et) is dgp_tpu_torch.emulator and len(et.all_layer_set) == 3
    _close_all(et.predict(z2, m=10), dgp_tpu.read_dgpsi(str(tmp_path / 'e')).predict(z2, m=10))


def _close_all(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)


# ----------------------------------------------------------------------
# the public API
# ----------------------------------------------------------------------
def test_exports_the_public_api():
    names = ('dgp', 'gp', 'emulator', 'kernel', 'combine', 'Poisson', 'Hetero', 'NegBin',
             'Categorical', 'ZIP', 'ZINB', 'container', 'lgp', 'path', 'write', 'read',
             'summary', 'nb_seed', 'set_thread', 'get_thread', 'read_dgpsi')
    for name in names:
        assert hasattr(dgp_tpu, name) and hasattr(dgp_tpu_torch, name), name


def test_import_loads_no_optional_package():
    """In a fresh process, importing the package after its own dependencies
    (torch, numpy, scipy) loads none of jax, dgp_tpu, tabulate, dill or
    matplotlib (some torch builds load dill themselves when it is
    installed, so the check is on what the package adds)."""
    code = ("import sys, torch, numpy, scipy.special\n"
            "before = set(sys.modules)\n"
            "import dgp_tpu_torch\n"
            "new = set(sys.modules) - before\n"
            "bad = [m for m in new if m.split('.')[0] in "
            "('jax', 'dgp_tpu', 'tabulate', 'dill', 'matplotlib')]\n"
            "print(sorted(bad))\n"
            "print(sorted(m for m in ('jax', 'tabulate', 'matplotlib') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__('pathlib').Path(__file__).parents[1]))
    assert out.stdout.split('\n')[:2] == ['[]', '[]']
