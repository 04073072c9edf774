"""Shared pieces of the benchmark's tests: the ``card`` marker (tests that
need an NVIDIA card; decided in the ``cuda`` fixture, never at import) and
small CPU versions of the cells."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402

#: the cells of BENCHMARK.json
CELLS = tuple(w["name"] for w in core.load_json(ROOT / "BENCHMARK.json")["workloads"])
#: cells whose files are kept, and whose comparison is tested, though
#: BENCHMARK.json leaves them out (PERF.md, Open questions)
HELD_OUT = ("vsi_n1e5.predict",)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def small_files(cell, monkeypatch):
    """The cell's files cut to a size a CPU test holds: n = 1200 (the IVF
    search engages above 1024 points, so the approximate-NN threshold is
    lowered to 1000 as the port's own tests do), m = 10, 2-iteration
    chunks after 6 (the NN refresh at 8 falls in the first); the linked
    system at n = 200 with 3 imputations."""
    spec, cfg, mix = (copy.deepcopy(x) for x in core.cell_files(cell))
    spec.update(check_units=2, check_from=3)
    if cell.startswith("vsi"):
        import dgp_tpu_torch.models.dgp as mdgp
        import dgp_tpu_torch.models.gp as mgp
        monkeypatch.setattr(mdgp, "APPROX_NN_N", 1000)
        monkeypatch.setattr(mgp, "APPROX_NN_N", 1000)
        cfg["data"]["n"] = 1200
        cfg.update(vecchia_m=10, pred_m=10, emulator_N=2)
        mix.update(warm_iterations=6, chunk=2)
        if "sizes_min" in mix:
            mix.update(sizes_min=20, sizes_max=60, sizes_count=4)
    else:
        cfg["model1"]["data"]["n"] = cfg["model2"]["data"]["n"] = 200
        cfg.update(lgp_N=3, pred_m=20, vecchia_m=10)
        mix["points"] = 30
    return spec, cfg, mix


def run_small(cell, monkeypatch, seed=2**31 + 7, seconds=2.0, dtype="float64", trace=0):
    import time
    return core.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                         dtype=dtype, files=small_files(cell, monkeypatch))
