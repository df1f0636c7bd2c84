"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port either. Names are compared whole, by
their top-level part: the port's name begins with the JAX package's."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "jincresize_tpu"}
# The repository's other measuring scripts, which the benchmark reads none of.
OTHER_TOOLS = {"bench", "chip_smoke", "tools"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_every_module_is_scanned():
    rel = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "reference/jinc_ewa.py", "entries/jinc_resizer.py",
            "metrics/fps.py"} <= rel  # fmt: skip


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_side_import(path):
    found = top_level_imports(path) & (JAX_SIDE | OTHER_TOOLS)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name
)
def test_reference_imports_nothing_of_the_port(path):
    found = top_level_imports(path) & (JAX_SIDE | {"jincresize_tpu_torch", "benchmark"})
    assert not found, f"{path} imports {found}"


def test_scan_sees_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jincresize_tpu_torch.api\nfrom jax.numpy import zeros\nimport numpy\n")
    found = top_level_imports(probe)
    assert found == {"jincresize_tpu_torch", "jax", "numpy"}
    assert not found & {"jincresize_tpu"}  # the port's name is not the JAX package's


def test_run_time_check_compares_whole_names(monkeypatch):
    """The check run.py makes once the window has closed: the port's
    modules pass, the JAX package's fail."""
    import types

    from benchmark import harness

    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jincresize_tpu_torch_probe.api", types.ModuleType("p"))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jincresize_tpu.golden", types.ModuleType("g"))
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("f"))
    assert set(harness.forbidden_modules()) == before | {"jincresize_tpu", "flax"}
