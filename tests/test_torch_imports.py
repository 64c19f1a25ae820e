"""The port imports neither JAX nor the JAX package.

An AST walk over every ``.py`` under ``src/repro_torch/`` and over
``chip_smoke.py`` fails on any import of ``jax``, ``jaxlib`` or
``repro`` / ``repro.*`` — ``repro_torch`` itself is not ``repro``."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def imported_modules(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.lineno, node.args[0].value


def test_the_walk_sees_the_whole_port():
    assert len(FILES) > 20
    assert ROOT / "src" / "repro_torch" / "kernels" / "ops.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path.read_text())
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,flagged", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True), ("import repro", True),
    ("from repro.kernels import ops", True),
    ("import importlib\nimportlib.import_module('repro.configs')", True),
    ("import repro_torch", False), ("from repro_torch.kernels import ops", False),
    ("from . import ops", False), ("import jaxtyping", False)])
def test_the_check_itself(source, flagged):
    assert any(_forbidden(m) for _, m in imported_modules(source)) == flagged
