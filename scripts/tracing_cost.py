"""The port's span recorder's cost when it records, on one serving cell.

    python3 scripts/tracing_cost.py --workload mistral-7b-v0.2.longdoc --seed 7 [--window 8] [--turns 8]

One process and one engine, set up and warmed as ``port_bench/core/serve.py``
does for an untraced run (``timing=False``); then ``--turns`` windows of
``--window`` seconds each, in the order off, on, on, off, off, on, ... where
"on" runs the window's iterations inside ``tracing.recording()`` (spans,
counts and device timing events, as under a profiler, without the
profiler). For each window: the end-to-end numbers of
``port_bench/core/timeline.py`` over it, its scheduler iterations and the
host microseconds an iteration. Prints one JSON line. On the card only.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.core import harness  # noqa: E402
from port_bench.core.serve import Loop, build_program  # noqa: E402
from port_bench.core.timeline import serving_metrics  # noqa: E402
from port_bench.core.traffic import buckets  # noqa: E402


def recorder_us(eng, dev, n: int = 4000) -> dict:
    """Host us of the recorder's own calls, on the engine's state after the
    windows: a span not recorded (``NULL``); a recorded span with its two
    device events, one ``resolve`` a span; and a burst's counts
    (``_burst_counts``, at the pool's burst and largest bucket)."""
    import torch

    from duo_attention_tpu_torch import tracing

    def per_call(fn, calls):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e6 * (time.perf_counter() - t) / calls

    def recorded():
        with tracing.span("cost", device=dev):
            pass
        tracing.resolve()

    out = {"span_off": per_call(lambda: tracing.span("cost", device=dev).close(), 10 * n)}
    with tracing.recording():
        out["span_on"] = per_call(recorded, n)
        out["burst_counts"] = per_call(lambda: eng._burst_counts(eng.decode_burst, eng.duo.max_cache_size), n)
    torch.cuda.synchronize(dev)
    tracing.clear()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--window", type=float, default=8.0)
    p.add_argument("--turns", type=int, default=8)
    args = p.parse_args()
    import torch

    from duo_attention_tpu_torch import tracing
    from duo_attention_tpu_torch.serving import ServingEngine

    harness.set_cache_dirs(ROOT)
    ctx = harness.Context.build(ROOT, args.workload, args.seed, args.window, False, T_START)
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 3
    torch.set_num_threads(4)
    dev = ctx.device = torch.device("cuda", 0)
    mix, closed = ctx.mix, ctx.mix["driver"] == "closed_loop"
    params, cfg, duo = build_program(ctx)
    eng = ServingEngine(params, cfg, duo, max_batch_size=mix["slots"], decode_burst=mix["decode_burst"], device=dev)
    loop = Loop(ctx, eng, closed)
    lo, hi = mix["prompt"]["min"] + 1, mix["prompt"]["max"] + mix["output"]["max"] + mix["decode_burst"]
    for b in buckets(lo, hi, duo.max_cache_size):
        eng.pool_graph(b, False)
    loop.t0 = time.monotonic()
    if closed:
        for _ in range(mix["clients"]):
            loop.submit(time.monotonic())
        while any(loop.lines[k].first_token() is None for k in list(loop.lines)[: mix["clients"]]):
            loop.iterate()
    else:
        while time.monotonic() < loop.t0 + mix["warm_s"]:
            loop.iterate()
    torch.cuda.synchronize(dev)
    windows = []
    for i in range(args.turns):
        on = i % 4 in (1, 2)
        tracing.clear()
        w0, iters, host = time.monotonic(), 0, 0.0
        with tracing.recording() if on else contextlib.nullcontext():
            while time.monotonic() < w0 + args.window:
                t = time.monotonic()
                loop.iterate()
                host += time.monotonic() - t
                iters += 1
        torch.cuda.synchronize(dev)
        w1 = time.monotonic()
        e2e = serving_metrics(loop.lines, w0, w1)
        windows.append({"recording": on, "iterations": iters, "host_us_per_iteration": 1e6 * host / iters,
                        "spans": len(tracing.spans()), "output_tokens_per_s": e2e["output_tokens_per_s"],
                        "tpot_p90_ms": e2e.get("tpot_p90_ms")})
        harness.log(json.dumps(windows[-1]))
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
                      "windows": windows, "recorder_us": recorder_us(eng, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
