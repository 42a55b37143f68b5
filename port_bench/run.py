"""Run one benchmark cell once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
driver and metrics are found by name (``core/harness.py``). The run measures
``duo_attention_tpu_torch`` on the card and nothing else: with no CUDA
device, or fewer than the cell asks for, it exits non-zero and prints no
result. With ``--trace 0`` the line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled span of the
window. The numbers that decide ``correct`` are printed beside their
limits as the last lines on standard error and, under ``checks``, as the
line's last key.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import harness  # noqa: E402
from port_bench.core.harness import log  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not 0 <= args.seed < 1 << 63:
        log(f"--seed {args.seed}: out of range")
        return 2

    harness.set_cache_dirs(ROOT)
    ctx = harness.Context.build(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    import torch

    harness.log(f"imports {time.monotonic() - T_START:.3f} s")
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(4)
    ctx.device = torch.device("cuda", 0)
    torch.zeros(1, device=ctx.device)
    log(f"the card's context {time.monotonic() - T_START:.3f} s")
    driver = harness.load_module("drivers", ctx.mix["driver"], ctx.bench_dir)
    outcome = driver.run(ctx)

    found = harness.forbidden_modules()
    if found:
        log(f"the process loaded {', '.join(found)}: the benchmark measures the PyTorch port alone")
        return 4
    metrics = {}
    for m in harness.cell_metrics(ctx.bench, ctx.cell, ctx.trace):
        if ctx.trace:
            value = harness.load_module("metrics", m["name"], ctx.bench_dir).read(outcome.record)
        else:
            value = outcome.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            log(f"metric {m['name']}: nothing to read in this run")
    checks = {name: {"value": value, "limit": limit} for name, value, limit in outcome.checks}
    correct = bool(outcome.checks) and all(harness.check_ok(v, lim) for _, v, lim in outcome.checks)
    correct = correct and outcome.failed == 0 and outcome.attempted > 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if ctx.trace:
        device["busy_s"] = outcome.busy_s
        device["window_s"] = outcome.window_s
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = checks
    for name, value, limit in outcome.checks:
        log(f"check {name}: {value!r} (limit {limit!r}) {'ok' if harness.check_ok(value, limit) else 'FAILED'}")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
