"""W8A8 + INT4-KV long-context serving demo.

Counterpart of duo_attention_tpu/demo.py (itself the counterpart of the
reference's demo/run_duo_w8a8kv4.py): INT8 weight/activation products, an
INT4 full-head KV cache, the duo head split at the requested sparsity, a
long prompt of filler with a needle sentence at 50% depth, chunked prefill
with live progress and memory readout, then greedy decode.

The weights are random (seed 0), so the response is noise; the demo shows the
path and its costs. On the card (the default):

    python -m duo_attention_tpu_torch.demo --num-layers 32 --len 131072 --prefill-chunk 4096

A prefill chunk that runs out of device memory is halved and the prefill
restarts (down to 1024), trading time to first token for fit.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .cache import kv_memory_bytes
from .config import PRESETS, DuoConfig
from .engine import DuoEngine
from .evals.niah import DEFAULT_ANSWER, DEFAULT_NEEDLE, DEFAULT_QUESTION, load_haystack
from .models import llama
from .patterns import load_attn_pattern, num_full_kv_heads_per_layer, sparsify_attention_heads
from .tokenizer import decode_ids, encode_ids, get_tokenizer
from .utils import synchronize


def _prefill_with_progress(engine, prompt):
    """engine.prefill, one chunk at a time, printing each chunk's rate and
    the cache's bytes. Returns (cache, last-token logits)."""
    cache = engine.new_cache()
    C = engine.duo.prefill_chunk_size
    logits, done = None, 0
    for off in range(0, prompt.shape[1], C):
        t0 = time.perf_counter()
        cache, logits = engine.prefill(prompt[:, off : off + C], cache, start=done)
        synchronize(engine.device)
        n = min(C, prompt.shape[1] - off)
        done += n
        dt = time.perf_counter() - t0
        print(f"[prefill] {done}/{prompt.shape[1]} tokens | chunk {dt:.2f}s ({n / dt:.0f} tok/s) | "
              f"KV alloc {kv_memory_bytes(cache) / 1e9:.2f} GB", flush=True)
    return cache, logits


def main(argv=None):
    p = argparse.ArgumentParser(description="duo-attention W8A8KV4 demo")
    p.add_argument("--model", default="Llama-3-8B-Instruct-Gradient-1048k")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--len", type=int, dest="target_len", default=262144)
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--attn-pattern", default=None)
    p.add_argument("--sink", type=int, default=64)
    p.add_argument("--recent", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=32768)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--tokenizer", default="byte")
    p.add_argument("--no-w8a8", action="store_true")
    p.add_argument("--no-int4-kv", action="store_true")
    p.add_argument("--quantize-embeds", action="store_true",
                   help="int8 embed/lm_head too (~1 GB less device memory)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

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
    # a multiple of 8192 above the prompt and the generation
    max_cache = -(-(args.target_len + args.max_new_tokens + 1024) // 8192) * 8192
    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=tuple(nf),
                    max_cache_size=max_cache, prefill_chunk_size=args.prefill_chunk)
    kv_quant = "none" if args.no_int4_kv else "int4"

    print(f"[demo] building {args.model} x{cfg.num_layers} layers, "
          f"full-kv-heads={nf[0]}/{cfg.num_kv_heads}, target {args.target_len} tokens", flush=True)
    if not args.no_w8a8:
        from .ops.quant import init_params_w8a8

        # one layer at a time: a bf16 8B model and its int8 copy never coexist
        params = init_params_w8a8(cfg, seed=0, device=args.device, quantize_embeds=args.quantize_embeds)
        print("[demo] weights quantized to W8A8 (per-channel int8 + dynamic per-token activation scales)")
    else:
        params = llama.init_params(cfg, seed=0, device=args.device)
    engine = DuoEngine(params, cfg, duo, device=args.device, kv_quant=kv_quant)

    tokenizer = get_tokenizer(args.tokenizer)
    ids = encode_ids(tokenizer, load_haystack(None, args.target_len * 6))
    needle_ids = encode_ids(tokenizer, DEFAULT_NEEDLE)
    q_ids = encode_ids(tokenizer, DEFAULT_QUESTION)
    ids = ids[: args.target_len - len(needle_ids) - len(q_ids)]
    insert = len(ids) // 2
    prompt = np.asarray(ids[:insert] + needle_ids + ids[insert:] + q_ids, np.int32)[None]
    print(f"[demo] prompt: {prompt.shape[1]} tokens (needle at 50% depth)", flush=True)

    t_start = time.perf_counter()
    while True:
        try:
            cache, logits = _prefill_with_progress(engine, prompt)
            break
        except torch.cuda.OutOfMemoryError:
            C = engine.duo.prefill_chunk_size // 2
            if C < 1024:
                raise
            print(f"[demo] prefill ran out of device memory — retrying with chunk {C}", flush=True)
            engine = DuoEngine(params, cfg, dataclasses.replace(duo, prefill_chunk_size=C),
                               device=args.device, kv_quant=kv_quant)
            torch.cuda.empty_cache()
    print(f"[prefill] total {time.perf_counter() - t_start:.1f}s")

    first = torch.argmax(logits, dim=-1)
    half = max(args.max_new_tokens // 2, 1)
    bucket = engine.bucket_for(prompt.shape[1] + args.max_new_tokens)
    t0 = time.perf_counter()
    tok_a, cache, nxt = engine._decode_burst(cache, first, half, bucket)  # captures the step on the card
    dt_cold = time.perf_counter() - t0
    dt = float("inf")
    tok_b = None
    for _ in range(3):  # best of three steady bursts on the same cache
        t0 = time.perf_counter()
        toks, cache, nxt2 = engine._decode_burst(cache, nxt, half, bucket)
        dt = min(dt, time.perf_counter() - t0)
        if tok_b is None:
            tok_b, nxt = toks, nxt2
    text = decode_ids(tokenizer, np.concatenate([tok_a, tok_b], axis=1)[0])
    print(f"[decode] {half} tokens in {dt:.2f}s steady ({half / dt:.1f} tok/s; first burst, its "
          f"capture included, {dt_cold:.1f}s)")
    print(f"[decode] response: {text[:400]!r}")
    print(f"[demo] expected needle answer: {DEFAULT_ANSWER!r}")
    if engine.device.type == "cuda":
        print(f"[mem] {torch.cuda.get_device_name(engine.device)}: "
              f"in_use={torch.cuda.memory_allocated(engine.device) / 1e9:.2f} GB, "
              f"peak={torch.cuda.max_memory_allocated(engine.device) / 1e9:.2f} GB")
    return text


if __name__ == "__main__":
    main()
