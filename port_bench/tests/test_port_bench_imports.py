"""Nothing under port_bench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: the port's package name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "duo_attention_tpu"}


def imported(path: Path):
    """Top-level names of every module a file imports (relative imports
    resolved against the benchmark's own package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("port_bench" if node.level else node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "duo_attention_tpu_torch" not in imported(path)
    assert not imported(path) & JAX


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import duo_attention_tpu_torch.serving\nfrom duo_attention_tpu.ops import flash\n")
    assert imported(f) == {"duo_attention_tpu_torch", "duo_attention_tpu"}
    f.write_text("import duo_attention_tpu_torch\n")
    assert not imported(f) & JAX
