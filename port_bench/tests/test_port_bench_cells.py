"""Every cell of BENCHMARK.json resolves to its files by name, the contract's
shapes hold, a new cell runs from new files alone, and run.py refuses to
measure without a card."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench.core import harness
from port_bench.core.harness import BENCH_DIR, Context, load_json, load_module

from .conftest import MIXES, ROOT, tiny_conf

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    conf = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    assert conf["name"] == cell["config"] and cell["chips"] == 1
    assert hasattr(load_module("drivers", mix["driver"]), "run")
    limits = harness.find_limits(conf, cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = harness.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert per_layer
    for m in per_layer:
        assert hasattr(load_module("metrics", m["name"]), "read")
        assert m["moves"] in names


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    cells = {c["name"] for c in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/") and all(NAME.match(k) for k in c["reduced"])
        assert load_json(ROOT / c["file"])["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(layer) <= 200 and "\n" not in layer for layer in layers)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_from_new_files_alone(tmp_path):
    """A copy of the harness gains a configuration, a mix and a per-layer
    metric as new files, and a BENCHMARK.json that names them; the copy's
    existing files are untouched, and the new cell runs on the CPU."""
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "configs" / "tiny-gqa.json").write_text(json.dumps(tiny_conf()))
    (bench_dir / "traffic" / "tiny-chat.json").write_text(json.dumps(MIXES["open"]))
    (bench_dir / "metrics" / "requests.count.py").write_text(
        "def read(record):\n    return float(len(record['iters'])) if record else None\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "tiny-gqa.tiny-chat", "config": "tiny-gqa", "traffic": "tiny-chat", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny-gqa.tiny-chat"]) if "workloads" in m else m
                           for m in BENCH["end_to_end"] if m["name"] != "train_tokens_per_s"]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "requests.count", "unit": "iters", "better": "higher", "source": "program_span",
         "layer": "serving scheduler", "moves": "tpot_p90_ms", "workloads": ["tiny-gqa.tiny-chat"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    ctx = Context.build(tmp_path, "tiny-gqa.tiny-chat", 5, 1.0, False, time.monotonic(), bench_dir=bench_dir)
    ctx.device = torch.device("cpu")
    out = load_module("drivers", ctx.mix["driver"], bench_dir).run(ctx)
    assert out.checks and all(harness.check_ok(v, lim) for _, v, lim in out.checks)
    names = [m["name"] for m in harness.cell_metrics(bench, ctx.cell, True)]
    assert "requests.count" in names and "serving.admit_share" not in names
    assert load_module("metrics", "requests.count", bench_dir).read({"iters": [1, 2, 3]}) == 3.0
    assert {p: p.read_bytes() for p in before} == before


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
