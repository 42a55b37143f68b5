"""Serving benchmark: the continuous-batching ServingEngine in W8A8KV4.

Counterpart of duo_attention_tpu/evals/serving_bench.py. Mixed or equal
prompt lengths go through the W8A8KV4 stack (random int8 weights, INT4
full-head cache) at the Llama-3-8B geometry; admission chunks interleave
with decode bursts, and more requests than slots reuse slots. It records

  * aggregate tokens/s (on the wall, and over the decode bursts alone) and
    each request's TTFT,
  * per-token latency percentiles (p50/p90/p99: each decode burst's wall
    time spread over the tokens it produced; the first burst, which holds
    the pool step's graph capture, is left out),
  * the admission-stall distribution (the wall time a scheduler iteration
    spent on one prefill chunk),
  * the timestamped scheduler trace.

Run (the card by default):
    python -m duo_attention_tpu_torch.evals.serving_bench --out-dir chiprun_out/serving

The engine stamps its own phases (``ServingEngine(timing=True)``), so this
script runs the shipped scheduler loop, ``engine.run()``, and only
aggregates the engine's events.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..cache import kv_memory_bytes
from ..config import PRESETS, DuoConfig
from ..ops.quant import init_params_w8a8_random
from ..serving import Request, ServingEngine

MODEL = "Llama-3-8B-Instruct-Gradient-1048k"


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else None


def model_cfg(args):
    """The 8B geometry cut to ``--layers``, or a whole ``--preset`` (small
    geometries for a CPU run)."""
    if args.preset:
        return PRESETS[args.preset]
    return dataclasses.replace(PRESETS[MODEL], num_layers=args.layers)


def run_bench_engine(args):
    """Run the bench; returns (report, the engine, whose pool and captured
    steps stay alive for a caller that profiles them)."""
    cfg = model_cfg(args)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    # rounded up to a multiple of 8192, as the JAX bench sizes its cache
    max_cache = -(-(max(prompt_lens) + args.headroom) // 8192) * 8192
    num_full = round(cfg.num_kv_heads * (1 - args.sparsity))
    duo = DuoConfig(sink_size=64, recent_size=256, num_full_kv_heads=(num_full,) * cfg.num_layers,
                    max_cache_size=max_cache, prefill_chunk_size=args.prefill_chunk)
    params = init_params_w8a8_random(cfg, seed=0, device=args.device)
    print(f"[serving] params ready; pool B={args.slots}, max_cache={max_cache}", flush=True)
    engine = ServingEngine(params, cfg, duo, max_batch_size=args.slots, kv_quant="int4",
                           decode_burst=args.decode_burst, device=args.device, timing=True)
    pool_kv = kv_memory_bytes(engine.cache)
    print(f"[serving] pool KV {pool_kv / 1e9:.2f} GB ({pool_kv / args.slots / 1e9:.2f} GB/slot)", flush=True)

    def make_requests():
        rng = np.random.default_rng(0)
        return [Request(rid=rid, prompt_ids=rng.integers(10, cfg.vocab_size - 10, plen, dtype=np.int32),
                        max_new_tokens=args.max_new) for rid, plen in enumerate(prompt_lens)]

    # Warm-up pass (the same workload on the same engine, results dropped):
    # the captured pool steps then exist before the measured pass.
    warmup_s = None
    if args.warmup_run:
        t0 = time.monotonic()
        for r in make_requests():
            engine.submit(r)
        engine.run()
        warmup_s = time.monotonic() - t0
        for log in (engine.finished, engine.trace, engine.timings, engine.ttft):
            log.clear()
        print(f"[serving] warm-up pass done in {warmup_s:.1f}s", flush=True)

    reqs = make_requests()
    submit_t = time.monotonic()
    for r in reqs:
        engine.submit(r)
    engine.run()  # the shipped scheduler loop
    wall = time.monotonic() - submit_t

    report = {
        "config": {
            "layers": cfg.num_layers, "quant": "w8a8 + int4 kv", "sparsity": args.sparsity,
            "slots": args.slots, "decode_burst": args.decode_burst, "prompt_lens": prompt_lens,
            "max_new_tokens": args.max_new, "max_cache_size": max_cache, "prefill_chunk": args.prefill_chunk,
            "pool_kv_gb": round(pool_kv / 1e9, 3), "warmup_run_s": round(warmup_s, 1) if warmup_s else None,
            "device": torch.cuda.get_device_name(0) if str(args.device).startswith("cuda") else str(args.device),
        },
        **summarize(engine, wall, prompt_lens),
    }
    return report, engine


def summarize(engine: ServingEngine, wall: float, prompt_lens) -> dict:
    """The report's measured sections from a ServingEngine(timing=True) that
    has run its requests in ``wall`` seconds: aggregate, per-token latency
    (the first decode burst, which holds the graph capture, left out),
    admission stalls, each request's TTFT, and the trace."""
    events = list(engine.timings)
    decode_events = [e for e in events if e["event"] == "decode"]
    admit_events = [e for e in events if e["event"] == "admit"]
    token_lat = []  # per-token latency samples (s)
    for i, e in enumerate(decode_events):
        if i == 0 or not e["produced"]:
            continue
        token_lat += [e["dur_s"] / (e["produced"] / e["live"])] * e["produced"]
    admit_stalls = [e["dur_s"] for e in admit_events]
    total_tokens = sum(len(r.generated) for r in engine.finished)
    decode_time = sum(e["dur_s"] for e in decode_events)
    admit_time = sum(e["dur_s"] for e in admit_events)
    return {
        "aggregate": {
            "requests": len(engine.finished),
            "total_generated_tokens": total_tokens,
            "wall_s": round(wall, 3),
            "tok_s_wall": round(total_tokens / wall, 2),
            "decode_time_s": round(decode_time, 3),
            "tok_s_decode_only": round(total_tokens / decode_time, 2) if decode_time else None,
            "prefill_tokens": int(sum(prompt_lens)),
            "prefill_tok_s": round(sum(prompt_lens) / admit_time, 1) if admit_time else None,
            "scheduler_iterations": len(events),
            "graph_captures": engine.graph_captures(),
        },
        "per_token_latency_s": {"p50": percentile(token_lat, 50), "p90": percentile(token_lat, 90),
                                "p99": percentile(token_lat, 99), "n": len(token_lat)},
        "admission_stall_s": {"count": len(admit_stalls), "p50": percentile(admit_stalls, 50),
                              "p90": percentile(admit_stalls, 90),
                              "max": max(admit_stalls) if admit_stalls else None},
        "requests": [{"rid": r.rid, "prompt_len": r.prompt_len, "generated": len(r.generated),
                      "ttft_s": round(engine.ttft[r.rid], 3)}
                     for r in sorted(engine.finished, key=lambda r: r.rid)],
        "trace": [{**e, "t": round(e["t"], 3), "dur_s": round(e["dur_s"], 4)} for e in events],
    }


def run_bench(args) -> dict:
    return run_bench_engine(args)[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ServingEngine benchmark (W8A8KV4)")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--preset", default=None, help="a PRESETS config instead of the 8B geometry (CPU runs)")
    # 8 slots at ~32k context, 256 new tokens each, max_cache 32768
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--decode-burst", type=int, default=16)
    p.add_argument("--max-new", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=4096)
    p.add_argument("--headroom", type=int, default=512)
    p.add_argument("--prompt-lens", default=",".join(["32256"] * 8))
    p.add_argument("--no-warmup-run", dest="warmup_run", action="store_false", default=True,
                   help="skip the un-instrumented warm-up pass")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default="chiprun_out/serving")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = run_bench(args)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    agg, lat = report["aggregate"], report["per_token_latency_s"]
    p50 = "n/a" if lat["p50"] is None else f"{lat['p50']:.4f}s"
    p99 = "n/a" if lat["p99"] is None else f"{lat['p99']:.4f}s"
    print(f"[serving] {agg['requests']} requests, {agg['total_generated_tokens']} tokens in {agg['wall_s']}s "
          f"({agg['tok_s_wall']} tok/s wall, {agg['tok_s_decode_only']} decode-only) | per-token "
          f"p50={p50} p99={p99} | report -> {path}", flush=True)


if __name__ == "__main__":
    main()
