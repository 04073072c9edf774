"""The port's parity harness (tools/parity_torch.py) on the CPU: it loads
neither jax nor dgp_tpu; its numpy log-loss and accuracy equal
scikit-learn's; the wine data file it reads (written by
tools/make_torch_parity_data.py) holds tools/parity_data.wine_data() bit
for bit; and the rows it recorded on the card (PARITY_torch.json) carry
the verdicts that tools/parity.py's gates give them."""
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import parity  # noqa: E402
import parity_data  # noqa: E402
import parity_torch  # noqa: E402

ROWS = ("step", "2d", "multioutput", "poisson", "dgp_poisson", "negbin", "zip",
        "linked", "vecchia", "vecchia_f32", "wine_reduced", "wine")


def test_import_loads_neither_jax_nor_dgp_tpu():
    code = ("import sys; sys.path.insert(0, 'tools'); import parity_torch; "
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'dgp_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_numpy_metrics_equal_sklearn():
    from sklearn.metrics import accuracy_score, log_loss
    rs = np.random.RandomState(0)
    y = rs.randint(0, 3, 50)
    p = rs.dirichlet(np.ones(3), 50)
    p[:5] = np.eye(3)[(y[:5] + 1) % 3]          # certain and wrong: clipped
    p[5:10] = np.eye(3)[y[5:10]]                # certain and right
    assert parity_torch.log_loss(y, p) == log_loss(y, p)
    assert parity_torch.log_loss(y, p.astype(np.float32)) == \
        log_loss(y, p.astype(np.float32))
    yb = rs.randint(0, 2, 40)
    pb = rs.rand(40)
    assert parity_torch.log_loss(yb, pb) == log_loss(yb, pb)
    assert parity_torch.log_loss(yb + 3, np.stack([1 - pb, pb], 1)) == \
        log_loss(yb + 3, np.stack([1 - pb, pb], 1))
    pred = np.argmax(p, axis=1)
    assert parity_torch.accuracy_score(y, pred) == accuracy_score(y, pred)
    with pytest.raises(ValueError):
        parity_torch.log_loss(np.zeros(4), rs.dirichlet(np.ones(3), 4))


def test_wine_file_is_parity_data():
    Xtr, Xte, ytr, yte = parity_data.wine_data()
    w = json.loads((ROOT / "dgp_tpu_torch" / "data" / "parity_wine.json").read_text())
    for name, a in (("Xtr", Xtr), ("Xte", Xte), ("ytr", ytr), ("yte", yte)):
        b = np.asarray(w[name])
        assert b.shape == a.shape and b.dtype.kind == a.dtype.kind
        np.testing.assert_array_equal(b, a)
    # scikit-learn's GPC on the split, as PARITY_r05.json records it
    r05 = json.loads((ROOT / "PARITY_r05.json").read_text())["wine"]
    assert round(w["sklearn_gpc_log_loss"], 4) == r05["sklearn_gpc_log_loss"]
    assert round(w["sklearn_gpc_accuracy"], 4) == r05["sklearn_gpc_accuracy"]


def test_recorded_rows_carry_parity_verdicts():
    """Every row of the table, run on the card, with its card, dtype and
    seconds; re-gating a copy with parity.apply_gate gives its verdict."""
    rec = json.loads((ROOT / "PARITY_torch.json").read_text())
    assert set(ROWS) <= set(rec) and "waiting" in rec["motorcycle"]
    for name in ROWS:
        row = rec[name]
        assert row["platform"] == "gpu" and "H100" in row["nvidia_smi"]
        assert row["dtype"] == ("float32" if name == "vecchia_f32" else "float64")
        assert row["wall_s"] > 0 and row["nb_seeds"] == list(parity_torch.seeds_of(name))
        gate = parity_torch.GATE_OF.get(name, name)
        assert row["gate_of"] == gate
        fresh = {k: v for k, v in copy.deepcopy(row).items() if k != "gate"}
        parity.apply_gate(gate, fresh)
        assert fresh["gate"] == row["gate"]
