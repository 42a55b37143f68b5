"""Efficiency benchmarks: prefill latency, decode latency, serving throughput,
KV memory.

Counterpart of duo_attention_tpu/evals/efficiency.py (itself the counterpart
of the reference's eval/efficiency/benchmark_{dynamic,static}.py): chunked
prefill latency over the whole context (median of runs), steady-state decode
latency with the cache advanced to the context length (best of repeats, the
engine's captured step replayed once a token on the card), the serving
pool's aggregate decode throughput, and the KV cache's bytes. Every timing
runs between ``torch.cuda.synchronize`` calls on the card.

Run on the card, the 8B geometry with random int8 weights and the INT4 cache:

    python -m duo_attention_tpu_torch.evals.efficiency --num-layers 32 \\
        --ctx-len 32768 --prefill-chunk 4096 --w8a8 --kv-quant int4 \\
        --sparsity 0.5 --serving-batch 8 --output chiprun_out/efficiency.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..cache import cache_constructor, kv_memory_bytes
from ..config import PRESETS, DuoConfig
from ..engine import DuoEngine, capture_step, capture_stream
from ..models import llama
from ..patterns import load_attn_pattern, num_full_kv_heads_per_layer, sparsify_attention_heads
from ..serving import _batched_decode_step
from ..utils import resolve_device, synchronize


def make_params(cfg, w8a8: bool, device):
    """Random weights from seed 0: int8 drawn directly with the int8
    embedding and head (W8A8), else bf16."""
    if w8a8:
        from ..ops.quant import init_params_w8a8_random

        return init_params_w8a8_random(cfg, seed=0, device=device)
    return llama.init_params(cfg, seed=0, device=device)


def build_engine(args, params=None):
    """(engine, cfg, duo) for the CLI's arguments; ``params`` (already made
    for this geometry) are used as they are."""
    cfg = PRESETS[args.model]
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    sink, recent = args.sink, args.recent
    if args.attn_pattern:
        heads, sink, recent = load_attn_pattern(args.attn_pattern)
        heads, _ = sparsify_attention_heads(heads, sparsity=args.sparsity)
        nf = num_full_kv_heads_per_layer(heads)[: cfg.num_layers]
    else:
        nf = (round(cfg.num_kv_heads * (1 - args.sparsity)),) * cfg.num_layers
    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=tuple(nf),
                    max_cache_size=args.ctx_len, prefill_chunk_size=args.prefill_chunk)
    device = getattr(args, "device", "cuda")
    if params is None:
        params = make_params(cfg, getattr(args, "w8a8", False), device)
    engine = DuoEngine(params, cfg, duo, batch_size=getattr(args, "batch_size", 1), device=device,
                       kv_quant=getattr(args, "kv_quant", "none"))
    return engine, cfg, duo


def bench_prefill(engine, ctx_len, runs=3):
    """Chunked prefill latency over ctx_len tokens (median of ``runs``, after
    one warm-up prefill that builds and loads every kernel). Each run's cache
    is dropped before the next one allocates its own. Returns (seconds, the
    cache's KV bytes)."""
    ids = np.zeros((1, ctx_len), np.int32)
    cache, _ = engine.prefill(ids)
    synchronize(engine.device)
    kv = kv_memory_bytes(cache)
    del cache
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        cache, _ = engine.prefill(ids)
        synchronize(engine.device)
        times.append(time.perf_counter() - t0)
        del cache
    return float(np.median(times)), kv


def bench_decode(engine, ctx_len, steps=64, warmup=8, repeats=3):
    """Steady-state decode latency a step with the cache advanced to near
    ctx_len (best of ``repeats`` bursts of ``steps``; on the card each step is
    one replay of the engine's captured step, the first burst of ``warmup``
    steps captures it). With engine.batch_size > 1 this is batched decode.
    Headroom covers every decoded token plus one burst of slack (decoding
    past max_cache_size poisons the output). Returns (seconds a step, KV
    bytes)."""
    headroom = repeats * steps + warmup + steps
    cache = engine.new_cache()
    cache.length.fill_(max(ctx_len - headroom, 0))
    token = torch.zeros((engine.batch_size,), dtype=torch.long, device=engine.device)
    bucket = engine.bucket_for(ctx_len)
    _, cache, token = engine._decode_burst(cache, token, warmup, bucket)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _, cache, token = engine._decode_burst(cache, token, steps, bucket)  # reads its tokens back
        best = min(best, time.perf_counter() - t0)
    return best / steps, kv_memory_bytes(cache)


def bench_serving(cfg, duo, batch, ctx_len, kv_quant="int4", steps=64, w8a8=True, params=None,
                  device="cuda"):
    """Aggregate batched-decode throughput of the serving pool: the
    decode-only cache (``cache.ring_capacity(decode_only=True)``, the
    ServingEngine's pool) with staggered per-sequence lengths, i.e. the
    continuous-batching steady state, every slot active. On the card the
    pool step (``serving._batched_decode_step``) is captured once and
    replayed; a warm burst of ``steps`` comes first, then the best of three.
    ``params``: weights already made for ``cfg`` (else random from seed 0).
    Returns (tokens a second, the pool's KV bytes)."""
    dev = resolve_device(device)
    if params is None:
        params = make_params(cfg, w8a8, dev)
    cache = cache_constructor(kv_quant)(cfg, duo, batch, torch.bfloat16, dev, decode_only=True)
    # staggered lengths, clamped so every sequence keeps steps+slack of
    # cache headroom (and never goes negative for tiny test configs)
    base = max(ctx_len - steps - 8 - 600, 1)
    cache.length = torch.tensor([max(base - 37 * i, 1) for i in range(batch)], dtype=torch.int32, device=dev)
    tokens = torch.zeros((batch,), dtype=torch.long, device=dev)
    active = torch.ones((batch,), dtype=torch.bool, device=dev)

    def step():
        tokens.copy_(_batched_decode_step(params, cfg, duo, cache, tokens, active, full_bucket=ctx_len))

    if dev.type == "cuda":
        graph = capture_step(step, capture_stream(dev), cache, (tokens, active))
        step = graph.replay

    def burst():
        for _ in range(steps):
            step()
        synchronize(dev)

    burst()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        burst()
        best = min(best, time.perf_counter() - t0)
    return batch * steps / best, kv_memory_bytes(cache)


def main(argv=None):
    p = argparse.ArgumentParser(description="efficiency benchmark")
    p.add_argument("--model", default="Llama-3-8B-Instruct-Gradient-1048k")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--attn-pattern", default=None)
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--sink", type=int, default=64)
    p.add_argument("--recent", type=int, default=256)
    p.add_argument("--ctx-len", type=int, default=131072)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--prefill-chunk", type=int, default=8192)
    p.add_argument("--decode-steps", type=int, default=64)
    p.add_argument("--skip-prefill", action="store_true")
    p.add_argument("--w8a8", action="store_true",
                   help="INT8 weight/activation linears + int8 embeds")
    p.add_argument("--kv-quant", choices=["none", "int4"], default="none",
                   help="INT4 token-paired KV cache (W8A8KV4 with --w8a8)")
    p.add_argument("--serving-batch", type=int, default=0,
                   help="also measure serving-pool aggregate decode at this batch")
    p.add_argument("--output", default="benchmark_result.txt")
    p.add_argument("--json-output", default=None,
                   help="also append one JSON object per run")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    engine, cfg, duo = build_engine(args)
    dev = engine.device
    record = {
        "model": args.model, "layers": cfg.num_layers, "ctx": args.ctx_len,
        "sparsity": args.sparsity, "sink": duo.sink_size, "recent": duo.recent_size,
        "chunk": duo.prefill_chunk_size, "batch": args.batch_size, "w8a8": bool(args.w8a8),
        "kv_quant": args.kv_quant,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    lines = [f"model={args.model} layers={cfg.num_layers} ctx={args.ctx_len} sparsity={args.sparsity} "
             f"sink={duo.sink_size} recent={duo.recent_size} chunk={duo.prefill_chunk_size}"]
    if not args.skip_prefill:
        t, kv = bench_prefill(engine, args.ctx_len)
        record.update(prefill_ttft_p50_s=t, prefill_tok_s=args.ctx_len / t)
        lines.append(f"prefill: {t:.3f} s total, {args.ctx_len / t:.0f} tok/s, kv_bytes={kv}")
    t, kv = bench_decode(engine, args.ctx_len, args.decode_steps)
    agg = args.batch_size / t
    record.update(decode_ms_per_step=t * 1e3, decode_tok_s=agg, kv_bytes=kv)
    lines.append(f"decode: {t * 1e3:.2f} ms/step, {agg:.1f} tok/s aggregate "
                 f"(batch={args.batch_size}), kv_bytes={kv}")
    if args.serving_batch:
        agg, kv = bench_serving(cfg, duo, args.serving_batch, args.ctx_len, kv_quant=args.kv_quant,
                                steps=args.decode_steps, w8a8=args.w8a8, params=engine.params,
                                device=dev)
        record.update(serving_batch=args.serving_batch, serving_tok_s=agg, serving_kv_bytes=kv)
        lines.append(f"serving: {agg:.1f} tok/s aggregate (batch={args.serving_batch}, compact pool), "
                     f"kv_bytes={kv}")
    if dev.type == "cuda":
        record["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev)
        lines.append(f"device {record['device']}: peak_bytes_in_use={record['peak_bytes_in_use']}")
    report = "\n".join(lines)
    print(report)
    with open(args.output, "a") as f:
        f.write(report + "\n\n")
    if args.json_output:
        with open(args.json_output, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record


if __name__ == "__main__":
    main()
