"""BENCHMARK.json and the cells' files: names, units, cross-references, and
a cell, a configuration and a per-layer metric added as files alone."""
import json
import re
import shutil

import pytest

from benchmark.harness import core
from conftest import CELLS, HELD_OUT, ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    assert len(set(names[:len(BENCH["configs"]) + len(BENCH["workloads"])])) == \
        len(BENCH["configs"]) + len(BENCH["workloads"])


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("cell", CELLS + HELD_OUT)
def test_workload_files_name_existing_pieces(cell):
    spec, config, mix = core.cell_files(cell)
    assert (ROOT / "benchmark" / "traffic" / f"{mix['driver']}.py").exists()
    assert config["name"] == spec["config"]
    entry = next((w for w in BENCH["workloads"] if w["name"] == cell), None)
    if entry is None:
        assert cell in HELD_OUT
        return
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        (spec["config"], spec["traffic"], spec["chips"])
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert (ROOT / cfg_entry["file"]).exists()
    for m in core.metrics_of(cell, "per_layer"):
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for m in core.metrics_of(cell, "end_to_end"):
        assert (ROOT / "benchmark" / "end_to_end" / f"{m['name']}.json").exists()
    assert {"setup_s"} < {m["name"] for m in core.metrics_of(cell, "end_to_end")}
    assert core.metrics_of(cell, "per_layer")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in core.metrics_of(cell, "end_to_end")}


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files (and names them in BENCHMARK.json); the
    harness finds and runs them with no existing file edited."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "lgp_gp_dgp_n2000.json").read_text())
    cfg["name"] = "lgp_new"
    (b / "configs" / "lgp_new.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "lgp_250pts.json").read_text())
    mix["points"] = 100
    (b / "traffic" / "lgp_100pts.json").write_text(json.dumps(mix))
    spec = json.loads((b / "workloads" / "lgp_n2000.predict.json").read_text())
    spec.update(config="lgp_new", traffic="lgp_100pts")
    (b / "workloads" / "lgp_new.predict.json").write_text(json.dumps(spec))
    (b / "metrics" / "points_per_request.py").write_text(
        "def read(trace):\n    return trace.work['points'] / trace.work['requests']\n")
    bench["workloads"].append({"name": "lgp_new.predict", "config": "lgp_new",
                               "traffic": "lgp_100pts", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lgp_n2000.predict" in m.get("workloads", []):
            m["workloads"].append("lgp_new.predict")
    bench["per_layer"].append({"name": "points_per_request", "unit": "pts", "better": "higher",
                               "source": "program_counter", "layer": "facades",
                               "moves": "predict_pts_s", "workloads": ["lgp_new.predict"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    found = core.cell_files("lgp_new.predict", bench=b)
    assert found[1]["name"] == "lgp_new" and found[2]["points"] == 100
    per_layer = [m["name"] for m in core.metrics_of("lgp_new.predict", "per_layer", root)]
    assert "points_per_request" in per_layer and "lgp_predict_mfu_pct" in per_layer
    reader = core.load_module(b / "metrics" / "points_per_request.py", "m_points")

    class T:
        work = {"points": 300, "requests": 3}
    assert reader.read(T()) == 100
    monkeypatch.setattr(core, "cell_files", lambda cell, bench=b: found)
    r = run_small("lgp_new.predict", monkeypatch, seconds=0.5)
    assert r["correct"] and r["work"]["points"] == 30 * r["attempted"]
