"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""
import ast
import subprocess
import sys

import pytest

from benchmark.harness import core
from conftest import ROOT

DRIVERS = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.py")
                 if not p.stem.startswith("_"))


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.partition(".")[0] in core.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "dgp_tpu_torch_extra", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert core.forbidden_modules() == ["jaxlib"]


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_drivers_modules_hold_no_jax(driver):
    """Imports the driver and every module of the port it drives, in a
    fresh process, and lists the top-level names it loaded."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import benchmark.traffic.{driver}; import benchmark.harness.core; "
            "import dgp_tpu_torch, dgp_tpu_torch.models.compiled, dgp_tpu_torch.models.mstep, "
            "dgp_tpu_torch.models.ensemble, dgp_tpu_torch.vecchia.nn; "
            "print(sorted({n.partition('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT / "benchmark").stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & core.FORBIDDEN, loaded & core.FORBIDDEN
    assert "dgp_tpu_torch" in loaded


def test_no_source_of_the_benchmark_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.partition(".")[0] for n in names} & core.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert all(a.name.partition(".")[0] in {"torch", "math", "numpy"}
                           for a in node.names), path
            if isinstance(node, ast.ImportFrom) and not node.level:
                assert node.module.partition(".")[0] in {"torch", "math", "numpy"}, path
