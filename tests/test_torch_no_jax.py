"""The port imports no JAX: an AST scan of every module of
maua_style_tpu_torch/ and of chip_smoke.py finds no import of jax, jaxlib,
optax, orbax or the JAX package.  (An import-time check cannot do this where
the interpreter imports jax at startup.)"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "maua_style_tpu"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "maua_style_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_sources_exist():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("maua_style_tpu_torch", "ops", "gram.py") in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
