"""The port stands alone: no module of duo_attention_tpu_torch, and not
chip_smoke.py, imports jax, the JAX package (whose __init__ pulls in jax),
ml_dtypes or the repo's bench.py. And it exports every name the JAX package
exports (its ``__all__``, read with ``ast`` so that nothing of JAX is imported).

The imports are read with ``ast``: a text search would also match the
port's own name, which starts with the JAX package's.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(REPO).as_posix()
               for p in (REPO / "duo_attention_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
# ml_dtypes comes with jax, and bench.py imports both: neither is on the card machine
FORBIDDEN = ("jax", "jaxlib", "duo_attention_tpu", "ml_dtypes", "bench")


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


def test_the_eval_stack_is_covered():
    for module in ("tokenizer", "demo", "train/data", "evals/niah", "evals/metrics", "evals/longbench",
                   "evals/longbench_data", "evals/efficiency", "evals/accuracy_loop", "models/constructed",
                   "models/synth"):
        assert f"duo_attention_tpu_torch/{module}.py" in FILES, module


def test_the_training_slice_is_covered():
    for module in ("ops/blockwise", "train/loss", "train/trainer", "train/pretrain", "evals/accuracy_loop"):
        assert f"duo_attention_tpu_torch/{module}.py" in FILES, module


def test_the_parallel_slice_is_covered():
    for module in ("parallel/__init__", "parallel/mesh", "parallel/dryrun"):
        assert f"duo_attention_tpu_torch/{module}.py" in FILES, module


def test_no_rank_worker_lives_in_a_test_module():
    """A spawned rank imports its function's module: the tests hand
    ``run_ranks`` functions of the port (``pmesh.``), never their own (a test
    module imports JAX)."""
    import re

    for path in sorted((REPO / "tests").glob("test_torch_*.py")):
        for fn in re.findall(r"run_ranks\(\s*([\w.]+)", path.read_text()):
            assert fn.startswith("pmesh."), (path.name, fn)


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    bad = [m for m in imported_modules((REPO / path).read_text()) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


# The layers below the engines (the kernels' wrappers, the cache, the model
# step, the mesh and its sharding rules) and the modules above them, which
# none of the lower ones may import, at any depth: a lower module that reaches
# up makes every change above it a change of the layer below.
PACKAGE = "duo_attention_tpu_torch"
LOWER = sorted([p.relative_to(REPO).as_posix() for p in (REPO / PACKAGE / "ops").glob("*.py")]
               + [f"{PACKAGE}/{m}.py" for m in ("cache", "config", "tracing", "utils", "models/llama",
                                                "parallel/mesh", "parallel/ulysses", "parallel/fsdp")])
HIGHER = ("engine", "serving", "evals", "train", "tokenizer", "patterns", "demo", "parallel.pipeline",
          "parallel.dryrun", "models.constructed", "models.convert")


def package_imports(path: str, source: str):
    """Every module the file ``path`` (relative to the repo) imports, in any
    scope, with relative imports resolved; ``from X import n`` gives X and
    X.n, since n may be a module."""
    package = path[: -len(".py")].split("/")[:-1]
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1] + ([node.module] if node.module else [])
                module = ".".join(base)
            else:
                module = node.module
            yield module
            yield from (f"{module}.{alias.name}" for alias in node.names)


def _higher(module: str) -> bool:
    return any(module == f"{PACKAGE}.{name}" or module.startswith(f"{PACKAGE}.{name}.") for name in HIGHER)


def test_the_layering_rule_catches_what_it_must():
    src = ("from ..engine import DuoEngine\nfrom . import pipeline\nfrom .mesh import Mesh\n"
           "def f():\n    from ..evals.niah import NIAHTester\n    from .. import serving\n"
           "    from ..models import llama, convert\n")
    got = [m for m in package_imports(f"{PACKAGE}/parallel/x.py", src) if _higher(m)]
    assert got == [f"{PACKAGE}.engine", f"{PACKAGE}.engine.DuoEngine", f"{PACKAGE}.parallel.pipeline",
                   f"{PACKAGE}.evals.niah", f"{PACKAGE}.evals.niah.NIAHTester", f"{PACKAGE}.serving",
                   f"{PACKAGE}.models.convert"]


@pytest.mark.parametrize("path", LOWER)
def test_lower_layers_import_nothing_above_them(path):
    bad = sorted({m for m in package_imports(path, (REPO / path).read_text()) if _higher(m)})
    assert not bad, f"{path} imports {bad}"


def _jax_all():
    """The names in duo_attention_tpu/__init__.py's ``__all__``."""
    tree = ast.parse((REPO / "duo_attention_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(elt) for elt in node.value.elts]
    raise AssertionError("duo_attention_tpu/__init__.py has no __all__")


JAX_ALL = _jax_all()


def test_the_jax_names_are_read():
    assert "DuoEngine" in JAX_ALL and "load_hf_model" in JAX_ALL and "reorder_params" in JAX_ALL


@pytest.mark.parametrize("name", JAX_ALL)
def test_the_port_exports_every_name_of_the_jax_package(name):
    import duo_attention_tpu_torch

    assert hasattr(duo_attention_tpu_torch, name), name
    assert name in duo_attention_tpu_torch.__all__, name
