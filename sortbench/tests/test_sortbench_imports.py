"""Nothing under sortbench/ imports the JAX stack, the JAX package or its
benchmark harness (top-level names compared whole: ``repro_torch``
begins with ``repro``), and the references import nothing of the
program."""
import ast

import pytest

from sortbench import harness

SORTBENCH = harness.HERE
FILES = sorted(p for p in SORTBENCH.rglob("*.py") if "__pycache__" not in
               p.parts)


def imported_top_levels(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_files_are_scanned():
    assert any(p.name == "harness.py" for p in FILES)
    assert any(p.parent.name == "metrics" for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(SORTBENCH)))
def test_no_jax_stack_or_jax_package(path):
    banned = imported_top_levels(path) & set(harness.BANNED_MODULES)
    assert not banned, f"{path} imports {banned}"


@pytest.mark.parametrize("path", sorted((SORTBENCH / "references").glob(
    "*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported_top_levels(path) <= {"__future__", "torch", "numpy",
                                         "math"}


def test_whole_name_comparison():
    assert "repro_torch" not in harness.BANNED_MODULES
    assert "repro" in harness.BANNED_MODULES
