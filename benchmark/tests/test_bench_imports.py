"""What the benchmark may import: nothing under ``benchmark/`` imports JAX,
its libraries or the JAX package (top-level names compared whole, since
the port's name begins with the JAX package's), and the plain reference
imports nothing of the program."""

from __future__ import annotations

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "maua_style_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs if f.endswith(".py"))


def top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(open(path).read(), path)
    assert not top_level_imports(path) & {"maua_style_tpu_torch", "benchmark"}
    # relative imports stay inside reference/
    assert all(n.level == 1 for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level)


def test_the_check_compares_whole_names():
    assert "maua_style_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "maua_style_tpu.ops".split(".")[0] in FORBIDDEN
