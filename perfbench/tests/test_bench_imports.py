"""Nothing under perfbench/ imports the JAX package or JAX, and the
reference imports nothing of the program, each checked by a module's
top-level name compared whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "egt_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "egt_torch" not in tops
    assert tops <= {"__future__", "hashlib", "math", "statistics",
                    "dataclasses", "numpy", "torch"}


def test_the_names_are_compared_whole():
    # the port's name begins with the JAX package's name
    assert "egt_torch" not in FORBIDDEN
    assert "egt_torch".split(".")[0] != "egt_tpu"
