"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Modules are compared by their
top-level name whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "etch_tpu"}
SOURCES = sorted(p for p in PERFBENCH.rglob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                tops.add(arg.value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    tops = imported_tops(path)
    assert "etch_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "functools", "math", "numpy", "torch", "scipy",
                    "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_the_tops_are_compared_whole():
    assert "etch_tpu_torch".split(".")[0] not in FORBIDDEN
