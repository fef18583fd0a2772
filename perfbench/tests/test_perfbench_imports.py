"""No module of the benchmark imports JAX, its libraries or the JAX
package, and the plain reference imports nothing of the program either.

Names are compared by their top-level part (before the first dot), whole:
``tpualign_torch`` is not ``tpualign``.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpualign"}
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"tpualign_torch"}
MODULES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    """The top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_every_module_is_walked():
    assert ROOT / "run.py" in MODULES
    assert any(p.parent.name == "reference" for p in MODULES)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    forbidden = FORBIDDEN_IN_REFERENCE if "reference" in path.relative_to(ROOT).parts else FORBIDDEN
    found = top_level_imports(path) & forbidden
    assert not found, f"{path.relative_to(ROOT)} imports {sorted(found)}"


@pytest.mark.parametrize("source, found", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from tpualign.models import clip", {"tpualign"}),
    ("from tpualign_torch.ops import attention", {"tpualign_torch"}),
    ("import importlib; importlib.import_module('flax.linen')", {"importlib", "flax"}),
    ("from . import clip", set()),
])
def test_the_walk_reads_each_form(tmp_path, source, found):
    path = tmp_path / "m.py"
    path.write_text(source)
    assert top_level_imports(path) == found
    assert "tpualign" not in top_level_imports(path) or "tpualign_torch" not in found
