"""What every run shares: finding a cell's files by name, the run's
context, the correctness checks, and the result line.

A cell (``BENCHMARK.json`` ``workloads[]``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
the mix names its driver (``drivers/<driver>.py``, a ``run(ctx)``
function); each per-layer metric is a reader ``metrics/<name>.py`` (a
``read(record)`` function that returns a number or None). A limit that
decides ``correct`` is found in ``limits/<workload>.json``, else in the
configuration's ``limits``: a later cell whose mix needs other limits on
a configuration that exists brings that file, since a configuration's file
may not be edited. Adding a cell, a configuration, a mix, a driver or a
metric is adding files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "duo_attention_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``<kind>/<name>.py`` under the benchmark, imported by path (names may
    hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off: those whose ``workloads``
    name the cell, or with no such key, as ``setup_s``) or its per-layer
    metrics (on: every one names its cells under ``workloads``)."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]


def find_limits(conf: dict, workload: str, bench_dir: Path = BENCH_DIR) -> Dict[str, float]:
    """``limits/<workload>.json`` where a cell brings one, else the
    configuration's ``limits``."""
    path = bench_dir / "limits" / f"{workload}.json"
    return load_json(path) if path.is_file() else dict(conf.get("limits", {}))


@dataclass
class Context:
    root: Path
    bench: dict
    cell: dict
    conf: dict
    mix: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    t_start: float  # the host clock at process start
    out_dir: Path = None
    device: object = None
    bench_dir: Path = BENCH_DIR

    @classmethod
    def build(cls, root: Path, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
              bench_dir: Path = BENCH_DIR):
        """The cell ``workload`` of ``root``/BENCHMARK.json, its files read
        from ``bench_dir``."""
        bench = load_json(root / "BENCHMARK.json")
        cell = find_cell(bench, workload)
        conf = load_json(bench_dir / "configs" / f"{cell['config']}.json")
        mix = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
        out = bench_dir / "out"
        out.mkdir(parents=True, exist_ok=True)
        return cls(root=root, bench=bench, cell=cell, conf=conf, mix=mix,
                   limits=find_limits(conf, workload, bench_dir), seed=seed, seconds=seconds, trace=trace,
                   t_start=t_start, out_dir=out, bench_dir=bench_dir)


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values by name (``setup_s``
    always), the traced record for the per-layer readers, the compared
    numbers (name, value, limit; a value above its limit, or not a number,
    fails), the counts, the memory peak and, traced, the device's busy and
    window seconds and the breakdown."""

    e2e: Dict[str, float]
    checks: List[Tuple[str, Optional[float], float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    record: Optional[dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: Dict[str, object] = field(default_factory=dict)


def check_ok(value: Optional[float], limit: float) -> bool:
    return value is not None and value == value and value <= limit


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process (top-level
    names compared whole)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every kernel cache at a fixed path inside the checkout. The port
    builds its CUDA sources into ``duo_attention_tpu_torch/build/`` there
    already; PyTorch's and Triton's own caches go under ``port_bench/out``."""
    cache = BENCH_DIR / "out" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
