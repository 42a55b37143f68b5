"""The port stands alone: no module of duo_attention_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package (whose __init__ pulls in jax).

The imports are read with ``ast``: a text search would also match the
port's own name, which starts with the JAX package's.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(REPO).as_posix()
               for p in (REPO / "duo_attention_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "duo_attention_tpu")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def imported_modules(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_the_rule_catches_what_it_must():
    src = "import jax.numpy as jnp\nfrom duo_attention_tpu.ops import flash\nimport duo_attention_tpu_torch\n"
    assert [m for m in imported_modules(src) if _forbidden(m)] == ["jax.numpy", "duo_attention_tpu.ops"]


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    bad = [m for m in imported_modules((REPO / path).read_text()) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"
