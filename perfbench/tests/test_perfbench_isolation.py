"""Nothing under perfbench/ imports JAX or the JAX package, and the
references import nothing of the program either: top-level module names
are compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tacorl_tpu"}


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(PERFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert not names & (FORBIDDEN | {"tacorl_tpu_torch", "chip_smoke", "tests"})


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import tacorl_tpu_torch.train\nfrom tacorl_tpu.core import trainer\nimport jax.numpy\n")
    assert imported_top_levels(f) & FORBIDDEN == {"tacorl_tpu", "jax"}


def test_the_harness_imports_neither_chip_smoke_nor_the_tests():
    for path in FILES:
        if "tests" in path.relative_to(PERFBENCH).parts:
            continue
        assert not imported_top_levels(path) & {"chip_smoke", "tests", "bench"}, path
