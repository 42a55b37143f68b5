#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (duo_attention_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, all of them on every run (any failure exits non-zero and prints no
result):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi).
  2. build: compile csrc/*.cu with nvcc (one process per source, in parallel).
  3. kernels vs plain: every kernel of the main path, in both formats, against
     its plain PyTorch version on the same inputs at the main path's shapes
     (head_dim 128, 4 query heads per KV head, chunk 4096, max_cache_size 32768,
     sink 64, recent 256; the 8B model's five weight shapes), prefill and
     decode, scalar and per-sequence lengths, ragged query tiles, a query group
     of 8, a ring walk that wraps, a sink not yet full, no sink, a tiny
     window, decode split plans with one, full, ragged and empty splits (and
     sweeps of other plans: the bf16 full-head decode's at the main shape, the
     streaming decode's at each main-path head count, B = 1 and 4); queries
     drawn 4x larger than keys, so scores are peaked and a dropped key shows;
     attention held to
     flash.kernel_tolerance (INT4: kernel_tolerance_q4), writes (the K/V pair
     forms and the streaming write read from strided views) and the int8
     matrix product bitwise; the small-M route as the decode step runs it (bf16
     x quantized inside the kernel, wq+wk+wv and gate+up in one launch each)
     at M = 1, 4 and 8, its weights cold in L2 (rotated copies); times of the
     kernel, the plain version and one library call (SDPA, index_copy_,
     torch._int_mm; for the small-M route several calls: the plain-torch
     quantization, then torch._int_mm with x padded to 17 rows), each as
     Python issues it and on the device alone, and the bound; an empty kernel
     over the streaming decode's grid, plainly and in its clusters, and over
     the streaming write's (the launch floor); the INT4 decode once more built
     with float32 FMAs in place of its tensor-core products (the measurement
     that chose them), and at each main-path head count; the serving pool's
     shapes: the streaming decode and the streaming write on its decode-only
     buffers (sink rows 72, ring R = 384, B = 4 and 8, [B] lengths and starts
     across the ring's wrap and before the sink is full), and the INT4 decode
     and the INT4 pair write at B = 8 with the bench's ragged lengths near
     32,500 beside short rows (bucket 32768).
  4. end to end, bf16: Llama-3-8B geometry (32 layers, random bf16 weights from
     a seed), the repo's NIAH pattern at sparsity 0.5, a 16,000-token prompt and
     64 greedy tokens through DuoEngine.generate; checks the cache length, the
     tokens and every kernel's launch count; prints TTFT, decode ms/token, the
     blocks the first decode (its graph capture included) left allocated, and
     a torch.profiler breakdown of device time for the prefill and 8 decode
     steps (with its copies, and no abs/round kernel of a plain-torch
     activation quantization left in the decode).
     Decode runs as the engine runs it on the card, one CUDA-graph replay a
     token, and beside it, on the same cache, as a loop of eager forward_chunk
     steps: ms/token, device ms a step, idle share, kernel launches a token
     (the counters) and launch calls the host makes a step (the profiler).
  5. kernel path vs plain path, bf16: the same geometry at 4 layers, a prompt
     that crosses a chunk boundary, teacher-forced through both paths; compares
     the logits of the prefill and of 8 decode steps.
  6. end to end, W8A8KV4: phase 4 with random int8 weights (int8 embedding and
     head) and DuoEngine(kv_quant="int4").
  7. kernel path vs plain path, W8A8KV4: phase 5 in that format.
  8. serving (ServingEngine: a decode-only pool with [B] lengths, admission
     chunk by chunk between decode bursts of 16, the pool step replayed from
     CUDA graphs, greedy and sampled rows):
     8c (run after phase 5, on the bf16 weights): 4 slots, 3 requests;
     8a (after phase 7, W8A8KV4): 4 slots, 6 requests of 16000, 3000, 9000,
        500, 12000 and 6000 tokens, 64 new tokens each, two sampled, one
        explicitly greedy, one with a stop token: a stop-free run comes
        first, and the stop token is the first token of the last request's
        stream there, past its first burst where it can be, that does not
        occur earlier in that stream (of the request before it where that
        stream has none). Both require that every request finishes, that the stopped
        request's stream is the stop-free run's cut just before its stop
        token, that a second run on a new engine gives the same tokens, that
        each greedy request's first token is its isolated DuoEngine.generate
        first token and its stream the isolated stream up to the isolated
        run's first top-2 logit gap below NEAR_TIE, and that the kernels of 8
        replays of the pool step (greedy, then sampled) equal 8 times the
        counters; they print the pool's KV bytes, the captures, TTFT, the
        per-token latency, the admission stalls and the pool step's device ms;
     8b: evals/serving_bench.py at its defaults (8 slots, 8 prompts of 32,256
        tokens, 256 new tokens each), without its warm-up pass; requires every
        token generated, then times the B = 8 pool step, greedy and sampled.
Then one JSON line of per-kernel numbers and, last, the device line. A
detailed record goes to chiprun_out/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Per-layer full KV heads of artifacts/niah_8b/pattern at sparsity 0.5.
EXPECTED_FULL_HEADS = (5, 5, 3, 6, 3, 4, 3, 2, 4, 4, 5, 6, 5, 3, 4, 3,
                       2, 5, 3, 4, 3, 4, 6, 4, 5, 4, 2, 4, 4, 4, 6, 3)
PROMPT_LEN, NEW_TOKENS = 16000, 64
CHUNK, MAX_CACHE, SINK, RECENT, GROUP, HEAD_DIM = 4096, 32768, 64, 256, 4, 128
ITERS = 10  # timed calls per kernel case (a third as many for the plain version)
Q_PEAK = 4.0  # phase 3 queries are this many times larger than the keys
# Phase 8: the serving pool, its bursts, and the requests of 8a (the 16k prompt
# takes 4 admission chunks between decode bursts) and of the short bf16 run
SERVE_SLOTS, SERVE_BURST, SERVE_NEW = 4, 16, 64
SERVE_LENS = (16000, 3000, 9000, 500, 12000, 6000)
SERVE_LENS_BF16 = (5000, 1200, 300)
NEAR_TIE = 0.25  # top-2 logit gap: about twice phase 7's largest |dlogit| on the H100 (0.1199)
# the pallas_call each kernel replaces
REPLACES = {
    "full_cache_attention.prefill": "duo_attention_tpu/ops/flash.py:467",
    "full_cache_attention.decode": "duo_attention_tpu/ops/flash.py:426",
    "streaming_cache_attention.prefill": "duo_attention_tpu/ops/flash.py:857",
    "streaming_cache_attention.decode": "duo_attention_tpu/ops/flash.py:857",
    "write_row": "duo_attention_tpu/ops/inplace.py:73",
    "write_streaming_rows": "duo_attention_tpu/ops/inplace.py:135",
    "full_cache_attention_q4.prefill": "duo_attention_tpu/ops/flash.py:667",
    "full_cache_attention_q4.decode": "duo_attention_tpu/ops/flash.py:620",
    "write_q4_token": "duo_attention_tpu/ops/inplace.py:212",
    "w8a8_matmul.tiled": "duo_attention_tpu/ops/gemm.py:78",
    # below M = 256 JAX leaves the quantization and the product to XLA
    "w8a8_matmul.small": "duo_attention_tpu/ops/quant.py:202",
}
SOURCES = {"full_cache_attention_q4": "flash_q4.cu", "full_cache_attention": "flash.cu",
           "streaming_cache_attention": "flash.cu", "write_row": "inplace.cu",
           "write_streaming_rows": "inplace.cu", "write_q4_token": "inplace.cu", "w8a8_matmul": "gemm.cu"}
FLASH_CU_KERNELS = ("prefill_kernel", "decode_kernel", "decode_merge_kernel", "stream_decode_kernel")  # profiler names
FMA_VARIANT = ("flash_q4", ("DUO_Q4_DECODE_FMA",))  # the INT4 decode with CUDA-core products
# device_breakdown: tiny kernels launched before the profiled window, and its range's name
PREROLL_LAUNCHES, WINDOW = 10000, "chip_smoke_window"
# PyTorch's elementwise kernels that only ops/quant.py::quantize_act_per_token
# runs on the decode step (abs and round), as the profiler names them
QUANTIZE_KERNELS = ("abs_kernel", "round_kernel")
# host calls that put work on the device, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# The 8B model's weight shapes (N = out features, K = in features).
GEMM_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (1024, 4096), "gate/up": (14336, 4096),
               "down": (4096, 14336), "head": (128256, 4096)}
# The small-M route's cases: each weight shape alone, and the two groups the
# decode step runs in one launch (label, output widths, K).
SMALL_CASES = [*((label, (N,), K) for label, (N, K) in GEMM_SHAPES.items()),
               ("wq+wk+wv", (4096, 1024, 1024), 4096), ("gate+up", (14336, 14336), 4096)]


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from duo_attention_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build(variants=[FMA_VARIANT])
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{name}] {line.strip()}", file=sys.stderr)
            # e.g. C7514: one branch around a wgmma or its wait and ptxas waits after every
            # wgmma of the function; nothing overlaps the tensor cores any more
            require("Potential Performance Loss" not in line, f"ptxas on {name}.cu: {line.strip()}")
    log(f"build: {sorted(paths)} in {secs:.1f} s")
    return secs


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


class Recorder:
    """Phase 3's results by kernel name; ``record`` logs one case and fails
    the run if the kernel disagreed with its plain version."""

    def __init__(self):
        self.results = {}

    def record(self, name, case, err, ok, times, bound, ratio=0.0, main=False, **extra):
        ms, device_ms, plain_ms, lib_ms, lib_device_ms = times
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms (device {lib_device_ms:.4f})"
        log(f"  {name:34s} {case:28s} err {err:.3e} (err/tol {ratio:.3f}) {'ok ' if ok else 'BAD'} "
            f"kernel {ms:.4f} ms (device {device_ms:.4f})  plain {plain_ms:.4f} ms  "
            f"library {lib}  bound {bound[0]:.4f} ms ({bound[1]})")
        self.results.setdefault(name, []).append(dict(
            case=case, max_abs_err=err, err_over_tol=ratio, ok=ok, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_device_ms=lib_device_ms, bound_ms=bound[0], bound_by=bound[1], main=main,
            **extra))
        require(ok, f"{name} {case}: kernel disagrees with its plain version (max err {err})")


def timed(kernel, plain, library=None):
    """Milliseconds per call: (the kernel as Python issues it, mean of ITERS
    back-to-back calls between CUDA events; the kernel on the device alone,
    replayed from a CUDA graph, which for the decode-sized kernels is much
    less; the plain version; the library call where there is one, as Python
    issues it and on the device alone, measured as the kernel is)."""
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    def window(label, fn):
        # each window ends in a synchronize, so a device fault raised here was
        # made by a launch of this window: its label says whose
        try:
            return fn()
        except RuntimeError as e:
            raise SmokeFailure(f"device fault in the {label}'s timing window: {e}") from e

    ms = window("kernel", lambda: cuda_time_ms(kernel, iters=ITERS, warmup=1))
    device_ms = window("kernel", lambda: cuda_graph_time_ms(kernel))
    plain_ms = window("plain version", lambda: cuda_time_ms(plain, iters=ITERS // 3, warmup=1))
    lib_ms = lib_device_ms = None
    if library is not None:
        lib_ms = window("library call", lambda: cuda_time_ms(library, iters=ITERS, warmup=1))
        lib_device_ms = window("library call", lambda: cuda_graph_time_ms(library, calls=3))
    return ms, device_ms, plain_ms, lib_ms, lib_device_ms


def _attn_tol_ok(got, want, q4=False):
    """|kernel - plain| against flash.kernel_tolerance(plain) elementwise:
    2^-7 |plain| + 2^-6 rms of the plain row (INT4: kernel_tolerance_q4, with
    2^-4 rms). Returns (max abs error, the largest error / tolerance, whether
    every element is within it)."""
    from duo_attention_tpu_torch.ops import flash

    err = (got.float() - want.float()).abs()
    tol = (flash.kernel_tolerance_q4 if q4 else flash.kernel_tolerance)(want)
    ratio = float((err / tol.clamp_min(1e-30)).max())
    return float(err.max()), ratio, bool((err <= tol).all())


def _decode_plan_sweep(call, span, heads):
    """Device ms of the bf16 decode call under other split plans than the one
    ``flash.decode_split_plan`` makes (the plan is a host function of the
    bucket, so it can be swapped for the sweep and put back)."""
    from duo_attention_tpu_torch.ops import flash
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    kept = flash.decode_split_plan
    sweep = {}
    try:
        for split_keys in (128, 256, 512, 1024, 2048, span):
            plan = (-(-span // split_keys), split_keys)
            flash.decode_split_plan = lambda span_, heads_, plan=plan: plan
            sweep[f"{plan[0]}x{plan[1]}"] = cuda_graph_time_ms(call)
    finally:
        flash.decode_split_plan = kept
    sweep["kept"] = "%dx%d" % kept(span, heads)
    log(f"  decode split plan sweep at span {span} (splits x keys: device ms): "
        + ", ".join(f"{k}: {v:.4f}" if k != "kept" else f"kept {v}" for k, v in sweep.items()))
    return sweep


def _stream_decode_sweep(randn):
    """Device ms of the streaming decode at the main path's streaming head
    counts (hs 2-6, B = 1 and 4, cs = 16000, sink 64, recent 256) under other
    split sizes than ``flash.stream_decode_split_plan`` picks (a split is a
    block of the (b, head)'s cluster; at most 8), each held to the plain
    version once (the plan is a host function of the window, so it can be
    swapped for the sweep and put back)."""
    import torch

    from duo_attention_tpu_torch.ops import flash
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    kept = flash.stream_decode_split_plan
    keys = SINK + RECENT + 1
    sweep = {}
    try:
        for hs in range(2, 7):
            for B in (1, 4):
                q = randn(B, 1, hs * GROUP, HEAD_DIM, mul=Q_PEAK)
                bufs = [randn(B, hs, SINK + CHUNK, HEAD_DIM), randn(B, hs, SINK + CHUNK, HEAD_DIM),
                        randn(B, hs, 4608, HEAD_DIM), randn(B, hs, 4608, HEAD_DIM)]
                cs = torch.full((B,), 16000, dtype=torch.int32, device="cuda")
                tot = cs + 1
                call = lambda: flash.streaming_cache_attention(q, *bufs, cs, tot, SINK, RECENT)  # noqa: E731
                want = flash.streaming_cache_attention_plain(q, *bufs, cs, tot, SINK, RECENT)
                row = {"kept": "%dx%d" % kept(SINK, RECENT, B * hs)}
                for split_keys in (48, 64, 80, 96, 112, 176, 336):
                    plan = (-(-keys // split_keys), split_keys)
                    flash.stream_decode_split_plan = lambda s_, r_, h_, plan=plan: plan
                    err, ratio, ok = _attn_tol_ok(call(), want)
                    require(ok, f"streaming decode, plan {plan}, hs={hs} B={B}: err {err}")
                    row[f"{plan[0]}x{plan[1]}"] = cuda_graph_time_ms(call)
                flash.stream_decode_split_plan = kept
                sweep[f"hs={hs} B={B}"] = row
                log(f"  streaming decode split sweep hs={hs} B={B} (splits x keys: device ms): "
                    + ", ".join(f"{k}: {v:.4f}" if k != "kept" else f"kept {v}" for k, v in row.items()))
    finally:
        flash.stream_decode_split_plan = kept
    return sweep


def _empty_kernel_ms(blocks, threads, cluster=0):
    """Device ms of an empty kernel over a grid of ``blocks`` blocks of
    ``threads`` (in clusters of ``cluster`` along x, 0: none), replayed from a
    CUDA graph as the kernels are timed: the launch floor under a kernel's time."""
    import torch

    from duo_attention_tpu_torch.ops import _build, flash
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    lib = flash._lib()

    def empty():
        err = lib.empty_kernel_launch(blocks, threads, cluster, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "empty_kernel_launch")

    return cuda_graph_time_ms(empty)


def _launch_floor(blocks, threads, cluster, kernel_device_ms):
    """The empty kernel over the streaming decode's grid at the main shape,
    plainly and in clusters of its splits."""
    floor = dict(plain_ms=_empty_kernel_ms(blocks, threads), cluster_ms=_empty_kernel_ms(blocks, threads, cluster),
                 blocks=blocks, threads=threads, cluster=cluster, kernel_device_ms=kernel_device_ms)
    log(f"  launch floor: an empty kernel over {blocks} blocks of {threads} threads: {floor['plain_ms']:.4f} ms "
        f"on the device, {floor['cluster_ms']:.4f} in clusters of {cluster}; the streaming decode "
        f"{kernel_device_ms:.4f}")
    return floor


def phase_kernels(rec):
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask, ring_mask, sink_mask
    from duo_attention_tpu_torch.engine import _next_bucket
    from duo_attention_tpu_torch.ops import flash, inplace

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    D, G = HEAD_DIM, GROUP
    Ts, R = SINK + CHUNK, ((RECENT + CHUNK + 511) // 512) * 512

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * mul).to(torch.bfloat16)

    def vec(x, B):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1).expand(B).long()

    record = rec.record

    def sdpa(q, k_cat, v_cat, mask):
        """One SDPA call on pre-expanded GQA K/V and a boolean mask (the yardstick)."""
        return lambda: F.scaled_dot_product_attention(q, k_cat, v_cat, attn_mask=mask)

    # --- full_cache_attention -------------------------------------------------
    Hkv = 4
    Hq = Hkv * G
    T = MAX_CACHE
    k = randn(4, Hkv, T, D)
    v = randn(4, Hkv, T, D)
    full_cases = [  # (case, B, S, cs[, KV heads, query heads per KV head])
        ("prefill cs=0", 1, CHUNK, 0),
        ("prefill cs=12288", 1, CHUNK, 12288),
        ("prefill cs=12300", 1, CHUNK, 12300),
        ("prefill cs=[B] B=4", 4, CHUNK, [0, 4096, 8192, 12300]),
        ("prefill S=1000 cs=12288", 1, 1000, 12288),  # S not a multiple of the query tile
        ("prefill S=65 cs=5000", 1, 65, 5000),  # one row in the tile's second half
        ("prefill cs=[B] B=4 G=8", 4, CHUNK, [0, 4096, 8192, 12300], 2, 8),
        ("decode cs=16000", 1, 1, 16000),
        ("decode cs=16000 B=4", 4, 1, 16000),
        ("decode cs=[B] B=4", 4, 1, [5, 4096, 12345, 32000]),  # empty splits
        ("decode cs=300 (one split)", 1, 1, 300),
        ("decode cs=32767 (last split full)", 1, 1, 32767),
        ("decode cs=16001 (odd tail)", 1, 1, 16001),
    ]
    for case, B, S, cs, *heads in full_cases:
        Hkv, G = heads or (4, GROUP)
        Hq = Hkv * G
        name = "full_cache_attention." + ("decode" if S == 1 else "prefill")
        csv = vec(cs, B)
        bucket = min(_next_bucket(int(csv.max()) + S), MAX_CACHE)
        q = randn(B, S, Hq, D, mul=Q_PEAK)
        kb, vb = k[:B, :Hkv].contiguous(), v[:B, :Hkv].contiguous()
        extra = {}
        if S == 1:
            nsplit, split_keys = flash.decode_split_plan(bucket, B * Hkv)
            extra = dict(nsplit=nsplit, split_keys=split_keys, blocks=B * Hkv * nsplit)
            log(f"  split plan for {case}: bucket {bucket}, {B * Hkv} (b, KV head) pairs -> "
                f"{nsplit} splits of {split_keys} keys, {B * Hkv * nsplit} blocks")
            require((nsplit == 1) == (bucket <= flash.DECODE_ONE_BLOCK_SPAN), f"{case}: {nsplit} splits")
        cs_arg = torch.as_tensor(cs, dtype=torch.int32, device=dev)
        got = flash.full_cache_attention(q, kb, vb, cs_arg, bucket=bucket)
        want = flash.full_cache_attention_plain(q, kb, vb, cs_arg, bucket=bucket)
        err, ratio, ok = _attn_tol_ok(got, want)
        span = bucket
        qpos = csv[:, None] + torch.arange(S, device=dev)
        mask = full_mask(qpos, span)[:, None]  # [B, 1, S, span]
        vis = int(mask.sum())
        flops = 4 * D * Hq * vis
        nbytes = 2 * (2 * B * S * Hq * D) + 2 * (2 * Hkv * D * int((csv + S).sum()))
        k_cat = kb[:, :, :span].repeat_interleave(G, dim=1)
        v_cat = vb[:, :, :span].repeat_interleave(G, dim=1)
        times = timed(
            lambda: flash.full_cache_attention(q, kb, vb, cs_arg, bucket=bucket),
            lambda: flash.full_cache_attention_plain(q, kb, vb, cs_arg, bucket=bucket),
            sdpa(q.transpose(1, 2), k_cat, v_cat, mask),
        )
        record(name, case, err, ok, times, _bound(flops, nbytes), ratio,
               main=case in ("prefill cs=12288", "decode cs=16000"), **extra)
        del k_cat, v_cat, mask
        if case == "decode cs=16000":
            require(extra["blocks"] > B * Hkv, "the decode kernel did not split the key range")
            rec.results["full_cache_attention.decode_plan_sweep"] = _decode_plan_sweep(
                lambda: flash.full_cache_attention(q, kb, vb, cs_arg, bucket=bucket), bucket, B * Hkv)
    del k, v
    Hkv, G = 4, GROUP

    # --- streaming_cache_attention --------------------------------------------
    Hs = 4
    Hq = Hs * G
    ks, vs = randn(4, Hs, Ts, D), randn(4, Hs, Ts, D)
    kr, vr = randn(4, Hs, R, D), randn(4, Hs, R, D)
    stream_cases = [  # (case, B, S, cs[, streaming KV heads, query heads per KV head, sink, recent])
        ("prefill cs=0", 1, CHUNK, 0),
        ("prefill cs=12288", 1, CHUNK, 12288),
        ("prefill cs=12300", 1, CHUNK, 12300),
        ("prefill cs=[B] B=4", 4, CHUNK, [0, 4096, 8192, 12300]),
        ("prefill cs=4000 (walk wraps)", 1, CHUNK, 4000),  # tokens 3744..8095 cross slot R = 4608
        ("prefill S=1000 cs=10 (cs < sink)", 1, 1000, 10),
        ("decode cs=16000", 1, 1, 16000),
        ("decode cs=16000 B=4", 4, 1, 16000),
        ("decode cs=[B] B=4", 4, 1, [5, 64, 4700, 32000]),
        ("decode cs=10 (cs < sink)", 1, 1, 10),
        ("decode cs=4700 (walk wraps)", 1, 1, 4700),  # tokens 4444..4700 cross slot R = 4608
        ("decode cs=16000 G=8", 1, 1, 16000, 2, 8),
        ("decode cs=16000 sink 0", 1, 1, 16000, 4, GROUP, 0, RECENT),
        ("decode cs=16000 recent 8", 1, 1, 16000, 4, GROUP, SINK, 8),  # a tiny window: one split
        ("decode cs=[B] B=4 recent 8", 4, 1, [3, 9, 70, 4700], 4, GROUP, SINK, 8),
    ]
    for case, B, S, cs, *geometry in stream_cases:
        Hs_c, G_c, sink, recent = (geometry + [4, GROUP, SINK, RECENT][len(geometry):])
        Hq_c = Hs_c * G_c
        name = "streaming_cache_attention." + ("decode" if S == 1 else "prefill")
        csv = vec(cs, B)
        q = randn(B, S, Hq_c, D, mul=Q_PEAK)
        bufs = [t[:B, :Hs_c].contiguous() for t in (ks, vs, kr, vr)]
        cs_arg = torch.as_tensor(cs, dtype=torch.int32, device=dev)
        tot_arg = cs_arg + S
        call = lambda: flash.streaming_cache_attention(q, *bufs, cs_arg, tot_arg, sink, recent)  # noqa: E731
        got = call()
        want = flash.streaming_cache_attention_plain(q, *bufs, cs_arg, tot_arg, sink, recent)
        err, ratio, ok = _attn_tol_ok(got, want)
        masks = []
        for b in range(B):
            qpos = csv[b] + torch.arange(S, device=dev)
            masks.append(torch.cat([sink_mask(qpos, sink, sink),
                                    ring_mask(qpos, R, csv[b] + S, csv[b], sink, recent)], dim=-1))
        mask = torch.stack(masks)[:, None]  # [B, 1, S, sink + R]
        vis = int(mask.sum())
        slots = int(mask.any(dim=2).sum())  # slots some query sees, over b
        flops = 4 * D * Hq_c * vis
        nbytes = 2 * (2 * B * S * Hq_c * D) + 2 * (2 * Hs_c * D * slots)
        k_cat = torch.cat([bufs[0][:, :, :sink], bufs[2]], dim=2).repeat_interleave(G_c, dim=1)
        v_cat = torch.cat([bufs[1][:, :, :sink], bufs[3]], dim=2).repeat_interleave(G_c, dim=1)
        times = timed(
            call,
            lambda: flash.streaming_cache_attention_plain(q, *bufs, cs_arg, tot_arg, sink, recent),
            sdpa(q.transpose(1, 2), k_cat, v_cat, mask),
        )
        extra = {}
        if S == 1:
            nsplit, split_keys = flash.stream_decode_split_plan(sink, recent, B * Hs_c)
            extra = dict(nsplit=nsplit, split_keys=split_keys, blocks=B * Hs_c * nsplit)
        record(name, case, err, ok, times, _bound(flops, nbytes), ratio,
               main=case in ("prefill cs=12288", "decode cs=16000"), **extra)
        del k_cat, v_cat, mask
        if case == "decode cs=16000":
            kernels = _device_kernels(call)
            require(len(kernels) == 1 and "stream_decode_kernel" in kernels[0],
                    f"the streaming decode launched {kernels}, not one stream_decode_kernel")
            rec.results["launch_floor"] = _launch_floor(extra["blocks"], 32 * extra["split_keys"] // 16,
                                                        extra["nsplit"], times[1])
    rec.results["streaming_cache_attention.decode_sweep"] = _stream_decode_sweep(randn)
    # the serving pool's decode-only buffers (cache.sink_rows / ring_capacity with decode_only:
    # sink rows 72, R = 384 at sink 64 / recent 256) at [B] lengths, B = 4 and 8
    Ts_pool, R_pool = SINK + 8, -(-(RECENT + 8) // 128) * 128
    for B in (4, 8):
        csl = [16000, 10, 383, 384, 32511, 700, 65, 5000][:B]  # before the sink is full, across the wrap
        csv = vec(csl, B)
        q = randn(B, 1, Hq, D, mul=Q_PEAK)
        pool = [randn(B, Hs, Ts_pool, D), randn(B, Hs, Ts_pool, D), randn(B, Hs, R_pool, D), randn(B, Hs, R_pool, D)]
        cs_arg = torch.tensor(csl, dtype=torch.int32, device=dev)
        tot_arg = cs_arg + 1
        call = lambda: flash.streaming_cache_attention(q, *pool, cs_arg, tot_arg, SINK, RECENT)  # noqa: E731
        want = flash.streaming_cache_attention_plain(q, *pool, cs_arg, tot_arg, SINK, RECENT)
        err, ratio, ok = _attn_tol_ok(call(), want)
        mask = torch.stack([torch.cat([sink_mask(csv[b][None], SINK, SINK),
                                       ring_mask(csv[b][None], R_pool, csv[b] + 1, csv[b], SINK, RECENT)], dim=-1)
                            for b in range(B)])[:, None]  # [B, 1, 1, sink + R_pool]
        nbytes = 2 * (2 * B * Hq * D) + 2 * (2 * Hs * D * int(mask.sum()))
        k_cat = torch.cat([pool[0][:, :, :SINK], pool[2]], dim=2).repeat_interleave(G, dim=1)
        v_cat = torch.cat([pool[1][:, :, :SINK], pool[3]], dim=2).repeat_interleave(G, dim=1)
        times = timed(call, lambda: flash.streaming_cache_attention_plain(q, *pool, cs_arg, tot_arg, SINK, RECENT),
                      sdpa(q.transpose(1, 2), k_cat, v_cat, mask))
        nsplit, split_keys = flash.stream_decode_split_plan(SINK, RECENT, B * Hs)
        record("streaming_cache_attention.decode", f"decode pool B={B} cs=[B] (sink rows {Ts_pool}, R={R_pool})",
               err, ok, times, _bound(4 * D * Hq * int(mask.sum()), nbytes), ratio, nsplit=nsplit,
               split_keys=split_keys, blocks=B * Hs * nsplit)
        del k_cat, v_cat, mask, pool
    del ks, vs, kr, vr

    # --- write_row: a layer's full-head K and V rows in one launch, read in place --
    # from [B, 1, Hkv, D] projections (the 8B model's 8 KV heads; 4 full ones), as
    # the decode step hands them; the one-buffer form (the JAX function's) last
    H, HKV = 4, 8
    batch_index = {n: torch.arange(n, device=dev) for n in (1, 4, 8)}

    def put_rows(buf, slot, row):
        """One indexed assignment: buf[b, :, slot[b]] = row[b, :, 0]."""
        buf[batch_index[buf.shape[0]], :, slot] = row[:, :, 0]

    for case, B, pos, pair in [("K+V pos=16000", 1, 16000, True), ("K+V pos=[B] B=4", 4, [0, 4096, 12345, 32767], True),
                               ("K+V pos=40000 (clamped) B=4", 4, 40000, True), ("one buffer pos=16000", 1, 16000, False)]:
        kbuf, vbuf = randn(B, H, T, D), randn(B, H, T, D)
        refs = kbuf.clone(), vbuf.clone()
        krow, vrow = (randn(B, 1, HKV, D)[:, :, :H].transpose(1, 2) for _ in range(2))  # strided views
        pos_arg = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        args = (kbuf, krow, pos_arg, vbuf, vrow) if pair else (kbuf, krow.contiguous(), pos_arg)
        ref_args = (refs[0], krow, pos_arg, refs[1], vrow) if pair else (refs[0], krow.contiguous(), pos_arg)
        inplace.write_row(*args)
        inplace.write_row_plain(*ref_args)
        ok = torch.equal(kbuf, refs[0]) and torch.equal(vbuf, refs[1])
        p = vec(pos, B).clamp(0, T - 1)
        nrows = 2 if pair else 1
        nbytes = nrows * 2 * (2 * B * H * D)

        def library():  # index_copy_ (B == 1) or an indexed assignment (B > 1), once a buffer
            for buf, row in ((kbuf, args[1]), (vbuf, vrow))[:nrows]:
                if B == 1:
                    buf.index_copy_(2, p[:1], row)
                else:
                    put_rows(buf, p, row)

        times = timed(lambda: inplace.write_row(*args), lambda: inplace.write_row_plain(*ref_args), library)
        record("write_row", case, 0.0 if ok else float("inf"), ok, times, _bound(0, nbytes),
               main=case == "K+V pos=16000")
        del kbuf, vbuf, refs

    # --- write_streaming_rows: a layer's streaming-head K and V rows, read in place ---
    # from [B, 1, Hkv, D] projections (the 8B model's 8 KV heads; the last 4 streaming),
    # as the decode step hands them: at B = 4 mixed starts, the ring's wrap, a sink not
    # full; then on the serving pool's decode-only buffers (sink rows 72, R = 384)
    for case, B, start, *rows in [("K+V start=16000 strided", 1, 16000),
                                  ("K+V start=[B] B=4 strided", 4, [5, 64, 4700, 32000]),
                                  ("K+V start=[B] B=4 wrap strided", 4, [4607, 4608, 9216, 63]),
                                  ("K+V pool start=[B] B=4 strided", 4, [63, 383, 384, 32511], Ts_pool, R_pool),
                                  ("K+V pool start=[B] B=8 strided", 8, [10, 64, 383, 384, 767, 768, 32511, 5000],
                                   Ts_pool, R_pool)]:
        Ts_c, R_c = rows or (Ts, R)
        bufs = [randn(B, H, Ts_c, D), randn(B, H, Ts_c, D), randn(B, H, R_c, D), randn(B, H, R_c, D)]
        refs = [t.clone() for t in bufs]
        k_row, v_row = (randn(B, 1, HKV, D)[:, :, HKV - H :].transpose(1, 2) for _ in range(2))  # strided views
        st = torch.as_tensor(start, dtype=torch.int32, device=dev)
        before = inplace.write_streaming_rows.launches
        inplace.write_streaming_rows(*bufs, k_row, v_row, st, SINK)
        ok = inplace.write_streaming_rows.launches == before + 1
        inplace.write_streaming_rows_plain(*refs, k_row, v_row, st, SINK)
        ok = ok and all(torch.equal(a, b) for a, b in zip(bufs, refs))
        t = vec(start, B)
        sink_slot, ring_slot = t.clamp(max=SINK), t % R_c
        nbytes = 2 * (2 * B * H * D) + 4 * (2 * B * H * D)

        def library():  # four index_copy_ (B == 1) or indexed assignments (B > 1)
            for buf, row, slot in ((bufs[0], k_row, sink_slot), (bufs[1], v_row, sink_slot),
                                   (bufs[2], k_row, ring_slot), (bufs[3], v_row, ring_slot)):
                if B == 1:
                    buf.index_copy_(2, slot, row)
                else:
                    put_rows(buf, slot, row)

        call = lambda: inplace.write_streaming_rows(*bufs, k_row, v_row, st, SINK)  # noqa: E731
        times = timed(call, lambda: inplace.write_streaming_rows_plain(*refs, k_row, v_row, st, SINK), library)
        # the launch floor under it: an empty kernel over the same grid (one block of 16 threads a row)
        threads = 2 * B * H * (D // 8)
        floor_ms = _empty_kernel_ms(1, threads)
        record("write_streaming_rows", case, 0.0 if ok else float("inf"), ok, times,
               _bound(0, nbytes), main=B == 1, floor_ms=floor_ms, threads=threads)
        log(f"    an empty kernel of 1 block x {threads} threads: {floor_ms:.4f} ms on the device; "
            f"the write {times[1]:.4f} (+{times[1] - floor_ms:.4f})")
        if B == 1:
            kernels = _device_kernels(call)
            require(kernels == [k for k in kernels if "write_streaming_rows_kernel" in k] and len(kernels) == 1,
                    f"the streaming write from strided rows ran {kernels}, not one write_streaming_rows_kernel")
        del bufs, refs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _small_case(rec, gen, label, ns, K, M, main=False):
    """The small-M route at the main path's decode shapes: bf16 x [M, K]
    through ``w8a8_linear_group`` (one launch, x quantized in the kernel)
    against its plain version, bitwise, and the int8-input mode against
    ``w8a8_matmul_plain``. Times, all with the weights cold: each call finds
    its weights outside the 50 MB L2, as a decode step does, by rotating over
    copies of them (at least 256 MB in all) inside one captured graph.
    Beside them the same kernel with one copy replayed (weights warm in L2).
    Library: plain-torch
    quantize_act_per_token, then per weight torch._int_mm (x padded to 17
    rows, its smallest M) and the two multiplies: several calls, no one call
    computes this. Bound: weights, x, the scales and the outputs once over
    the memory rate (or the int8 operations over the int8 peak)."""
    import torch

    from duo_attention_tpu_torch.ops import gemm, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    dev = gen.device
    out_dtype = torch.float32 if label == "head" else torch.bfloat16
    group_bytes = sum(ns) * K
    copies = [[(torch.randint(-127, 128, (n, K), generator=gen, device=dev, dtype=torch.int8),
                torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4) for n in ns]
              for _ in range(max(2, -(-(256 << 20) // group_bytes)))]
    x = (torch.randn((M, K), generator=gen, device=dev) * 2).to(torch.bfloat16)
    weights = copies[0]
    got = quant.w8a8_linear_group(x, weights, out_dtype)
    want = quant.w8a8_linear_group(x, weights, out_dtype, plain=True)
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    xq, xs = quant.quantize_act_per_token(x)
    for wq, ws in weights:  # the int8-input mode (route="small"), bitwise
        ok = ok and torch.equal(gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype, route="small"),
                                gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype))

    def library(ws_):
        xq_, xs_ = quant.quantize_act_per_token(x)
        xp = torch.cat([xq_, xq_.new_zeros(17 - M, K)])
        return [((torch._int_mm(xp, wq.t())[:M].float() * xs_) * s).to(out_dtype) for wq, s in ws_]

    require(all(torch.equal(a, b) for a, b in zip(library(weights), want)),
            f"quantize + torch._int_mm disagrees with the plain version ({label}, M={M})")

    def cold(fn):
        def calls():
            for ws_ in copies:
                fn(ws_)
        return calls

    kernel = cold(lambda ws_: quant.w8a8_linear_group(x, ws_, out_dtype))
    n = len(copies)
    times = (cuda_time_ms(kernel, iters=2, warmup=1) / n, cuda_graph_time_ms(kernel, calls=2) / n,
             cuda_time_ms(lambda: quant.w8a8_linear_group(x, weights, out_dtype, plain=True), iters=2, warmup=1),
             cuda_time_ms(cold(library), iters=2, warmup=1) / n, cuda_graph_time_ms(cold(library), calls=2) / n)
    warm_ms = cuda_graph_time_ms(lambda: quant.w8a8_linear_group(x, weights, out_dtype))
    nbytes = group_bytes + M * K * 2 + 4 * sum(ns) + M * sum(ns) * (4 if out_dtype == torch.float32 else 2)
    dt = "f32" if out_dtype == torch.float32 else "bf16"
    shape = "+".join(str(n) for n in ns)
    rec.record("w8a8_matmul.small", f"{label} {shape}x{K} M={M} {dt} cold", err, ok, times,
               _bound(2 * M * sum(ns) * K, nbytes, PEAK_INT8_OPS), main=main, warm_device_ms=warm_ms, copies=n,
               gbytes_per_s=nbytes / times[1] / 1e6, library_calls="quantize_act_per_token + torch._int_mm "
               "(x padded to 17 rows) + 2 multiplies, per weight")
    log(f"    {label} M={M}: weights warm in L2 (one copy replayed) {warm_ms:.4f} ms; "
        f"{nbytes / times[1] / 1e6:.0f} GB/s cold")
    del copies


def phase_kernels_w8a8kv4(rec):
    """Phase 3 for the three kernels of the W8A8KV4 format."""
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask
    from duo_attention_tpu_torch.engine import _next_bucket
    from duo_attention_tpu_torch.ops import flash, gemm, inplace, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    D, G, T = HEAD_DIM, GROUP, MAX_CACHE
    record = rec.record

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * mul).to(torch.bfloat16)

    def rand_q8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    # --- w8a8_matmul: bitwise ---------------------------------------------------
    # The tiled route (prefill) from int8 x. Operations: 2*M*N*K int8 operations.
    # Bytes: x, w, both scale vectors, the output.
    def gemm_case(label, N, K, M, out_dtype, main=False):
        xq, wq = rand_q8(M, K), rand_q8(N, K)
        xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
        ws = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        got = gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype)
        want = gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype)
        ok = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        nbytes = M * K + N * K + 4 * (M + N) + M * N * got.element_size()
        wt = wq.t()
        library = lambda: ((torch._int_mm(xq, wt).float() * xs) * ws).to(out_dtype)  # noqa: E731
        require(torch.equal(library(), want), f"torch._int_mm disagrees with the plain version ({label})")
        times = timed(lambda: gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype),
                      lambda: gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype), library)
        require(M > gemm.SMALL_M_MAX, f"{label}: M={M} would not take the tiled route")
        dt = "f32" if out_dtype == torch.float32 else "bf16"
        record("w8a8_matmul.tiled", f"{label} {N}x{K} M={M} {dt}", err, ok, times,
               _bound(2 * M * N * K, nbytes, PEAK_INT8_OPS), main=main, tops=2 * M * N * K / times[1] / 1e9,
               gbytes_per_s=nbytes / times[1] / 1e6)

    for label, (N, K) in GEMM_SHAPES.items():
        # (the main path runs the head at M = B only; M = 4096 is here for the float32 tiled epilogue)
        gemm_case(label, N, K, CHUNK, torch.float32 if label == "head" else torch.bfloat16, main=label == "gate/up")
    torch.cuda.empty_cache()
    for label, ns, K in SMALL_CASES:
        for M in (1, 4, 8):
            _small_case(rec, gen, label, ns, K, M, main=(label, M) == ("gate+up", 1))
    torch.cuda.empty_cache()

    # Where the routes cross: device time of both kernels at M from 1 to 256, two
    # weight shapes. Back-to-back launches from Python measure the host at these
    # sizes, so each route's calls are captured into a CUDA graph and replayed;
    # the calls rotate over 256 MB of weight copies, so none finds its weights in
    # the 50 MB L2, as in a decode step.
    sweep = {}
    for label in ("wq/wo", "gate/up"):
        N, K = GEMM_SHAPES[label]
        copies = [rand_q8(N, K) for _ in range(-(-(256 << 20) // (N * K)))]
        ws = torch.full((N,), 1e-3, device=dev)
        for M in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            xq, xs = rand_q8(M, K), torch.full((M, 1), 1e-2, device=dev)
            t = {}
            for route in ("small", "tiled"):
                def calls():
                    for wq in copies:
                        gemm.w8a8_matmul(xq, xs, wq, ws, route=route)
                t[route] = cuda_graph_time_ms(calls, calls=2) / len(copies)
            sweep[f"{label} M={M}"] = dict(small_ms=t["small"], tiled_ms=t["tiled"],
                                           weight_bytes_bound_ms=N * K / PEAK_BYTES * 1e3)
            log(f"  w8a8_matmul route sweep {label:8s} {N}x{K} M={M:4d}: small {t['small']:.4f} ms  "
                f"tiled {t['tiled']:.4f} ms  (weights alone at the memory rate: {N * K / PEAK_BYTES * 1e3:.4f} ms)")
        del copies
    rec.results["w8a8_matmul.route_sweep"] = sweep
    torch.cuda.empty_cache()

    # --- write_q4_token: bitwise ------------------------------------------------
    # a layer's full-head K and V rows in one launch, read in place from [B, 1,
    # Hkv, D] projections (the 8B model's 8 KV heads; 4 full ones), as the decode
    # step hands them; the one-buffer form (the JAX function's) after them
    H, HKV, T2 = 4, 8, T // 2
    for case, B, start, pair in [("K+V t=16000 (even)", 1, 16000, True), ("K+V t=16001 (odd)", 1, 16001, True),
                                 ("K+V t=[B] B=4", 4, [0, 4097, 12345, 32767], True),
                                 # the bench's pool: ragged lengths near 32,500 beside short rows
                                 ("K+V t=[B] B=8", 8, [32500, 32511, 32256, 32301, 5, 300, 16001, 32767], True),
                                 ("t=16000 (even)", 1, 16000, False), ("t=16001 (odd)", 1, 16001, False),
                                 ("t=[B] B=4", 4, [0, 4097, 12345, 32767], False),
                                 ("t=40000 (clamped) B=4", 4, 40000, False)]:
        nrows = 2 if pair else 1
        bufs = [(torch.randint(0, 256, (B, H, T2, D), generator=gen, device=dev, dtype=torch.uint8),
                 randn(B, H, 4, T2)) for _ in range(nrows)]
        befores = [(q_.clone(), s_.clone()) for q_, s_ in bufs]
        refs = [(q_.clone(), s_.clone()) for q_, s_ in bufs]
        rows = [randn(B, 1, HKV, D, mul=2.0)[:, :, :H].transpose(1, 2) for _ in range(nrows)]  # strided views
        st = torch.as_tensor(start, dtype=torch.int32, device=dev)
        args = (*bufs[0], rows[0], st, *bufs[1], rows[1]) if pair else (*bufs[0], rows[0], st)
        ref_args = (*refs[0], rows[0], st, *refs[1], rows[1]) if pair else (*refs[0], rows[0], st)
        before = inplace.write_q4_token.launches
        inplace.write_q4_token(*args)
        ok = inplace.write_q4_token.launches == before + 1
        inplace.write_q4_token_plain(*ref_args)
        tv = torch.as_tensor(start, device=dev).reshape(-1).expand(B).clamp(0, T - 1)
        keep = torch.where(tv % 2 == 1, 0x0F, 0xF0).to(torch.uint8)[:, None, None]
        bi = torch.arange(B, device=dev)
        untouched = torch.ones((B, T2), dtype=torch.bool, device=dev)
        untouched[bi, tv // 2] = False
        for (bq, bs), (ref_q, ref_s), (before_q, before_s) in zip(bufs, refs, befores):
            ok = ok and torch.equal(bq, ref_q) and torch.equal(bs.view(torch.int16), ref_s.view(torch.int16))
            # exactly one byte row per (b, head) changed, and in it only the token's nibble
            ok = ok and torch.equal(bq[bi, :, tv // 2] & keep, before_q[bi, :, tv // 2] & keep)
            ok = ok and torch.equal(bq.transpose(1, 2)[untouched], before_q.transpose(1, 2)[untouched])
            ok = ok and int((bs.view(torch.int16) != before_s.view(torch.int16)).sum()) <= 2 * B * H
        nbytes = nrows * B * H * (2 * D + 2 * D + 4)
        times = timed(lambda: inplace.write_q4_token(*args), lambda: inplace.write_q4_token_plain(*ref_args))
        record("write_q4_token", case, 0.0 if ok else float("inf"), ok, times, _bound(0, nbytes),
               main=case == "K+V t=16000 (even)")
        del bufs, refs, befores

    # --- full_cache_attention_q4 -------------------------------------------------
    Hkv = 4
    Hq = Hkv * G
    kq, ks = quant.quantize_int4_paired(randn(8, Hkv, T, D))
    vq, vs = quant.quantize_int4_paired(randn(8, Hkv, T, D))
    q4_cases = [  # (case, B, S, cs[, bucket])
        ("prefill cs=0", 1, CHUNK, 0),
        ("prefill cs=12288", 1, CHUNK, 12288),
        ("prefill cs=12300", 1, CHUNK, 12300),
        ("prefill cs=12301 (odd)", 1, CHUNK, 12301),
        ("prefill cs=[B] B=4", 4, CHUNK, [0, 4096, 8192, 12301]),
        ("decode cs=16000", 1, 1, 16000),
        ("decode cs=16001 (odd)", 1, 1, 16001),
        ("decode cs=16000 B=4", 4, 1, 16000),
        ("decode cs=[B] B=4", 4, 1, [5, 4096, 12345, 32000]),
        # the bench's B = 8 pool (bucket 32768): ragged lengths near 32,500 beside short rows
        ("decode cs=[B] B=8", 8, 1, [32500, 32511, 32256, 32301, 5, 300, 16001, 32767]),
        ("decode cs=300 bucket 32768 (most splits empty)", 1, 1, 300, MAX_CACHE),
    ]
    for case, B, S, cs, *fixed_bucket in q4_cases:
        name = "full_cache_attention_q4." + ("decode" if S == 1 else "prefill")
        csv = torch.as_tensor(cs, dtype=torch.int32, device=dev).reshape(-1).expand(B).long()
        bucket = fixed_bucket[0] if fixed_bucket else min(_next_bucket(int(csv.max()) + S), MAX_CACHE)
        q = randn(B, S, Hq, D, mul=Q_PEAK)
        bufs = [t[:B].contiguous() for t in (kq, ks, vq, vs)]
        cs_arg = torch.as_tensor(cs, dtype=torch.int32, device=dev)
        got = flash.full_cache_attention_q4(q, *bufs, cs_arg, bucket=bucket)
        want = flash.full_cache_attention_q4_plain(q, *bufs, cs_arg, bucket=bucket)
        err, ratio, ok = _attn_tol_ok(got, want, q4=True)
        span = bucket
        mask = full_mask(csv[:, None] + torch.arange(S, device=dev), span)[:, None]  # [B, 1, S, span]
        flops = 4 * D * Hq * int(mask.sum())
        tokens = int((csv + S).sum())  # slots some query sees, over b
        # q and out in bf16; per visible slot and KV head D/2 packed bytes and 4 scale bytes, for K and for V
        nbytes = 2 * (2 * B * S * Hq * D) + 2 * Hkv * tokens * (D // 2 + 4)
        # the yardstick: SDPA over a bf16 copy dequantized beforehand (its time apart)
        rows = span // 2
        dequant = lambda: (quant.dequantize_int4_paired(bufs[0][:, :, :rows], bufs[1][..., :rows]).bfloat16(),  # noqa: E731
                           quant.dequantize_int4_paired(bufs[2][:, :, :rows], bufs[3][..., :rows]).bfloat16())
        dequant_ms = cuda_time_ms(dequant, iters=3, warmup=1)
        kd, vd = dequant()
        k_cat, v_cat = kd.repeat_interleave(G, dim=1), vd.repeat_interleave(G, dim=1)
        qt = q.transpose(1, 2)
        times = timed(
            lambda: flash.full_cache_attention_q4(q, *bufs, cs_arg, bucket=bucket),
            lambda: flash.full_cache_attention_q4_plain(q, *bufs, cs_arg, bucket=bucket),
            lambda: F.scaled_dot_product_attention(qt, k_cat, v_cat, attn_mask=mask),
        )
        extra = {}
        if S == 1:
            nsplit, split_keys = flash.q4_decode_split_plan(bucket, B * Hkv)
            extra = dict(nsplit=nsplit, split_keys=split_keys, blocks=B * Hkv * nsplit)
        record(name, case, err, ok, times, _bound(flops, nbytes), ratio,
               main=case in ("prefill cs=12288", "decode cs=16000"), library_dequant_ms=dequant_ms, **extra)
        log(f"    device ms: kernel {times[1]:.4f} against dequantize + SDPA {dequant_ms + times[4]:.4f}"
            + (f"; plan {extra['nsplit']} splits x {extra['split_keys']} keys, {extra['blocks']} blocks" if extra else ""))
        del kd, vd, k_cat, v_cat, mask
        if case == "decode cs=16000":
            call = lambda: flash.full_cache_attention_q4(q, *bufs, cs_arg, bucket=bucket)  # noqa: E731
            kernels = _device_kernels(call)
            require(len(kernels) == 1 and "decode_q4_kernel" in kernels[0],
                    f"INT4 decode launched {kernels}, not one decode_q4_kernel")
            rec.results["full_cache_attention_q4.decode_products"] = _q4_decode_products(call, want, times)
    # the INT4 decode at each full-head count of the main path's layers (B = 1, cs = 16000)
    by_hf = {}
    for hf in range(2, 7):
        kq6, ks6 = quant.quantize_int4_paired(randn(1, hf, 16384, D))
        vq6, vs6 = quant.quantize_int4_paired(randn(1, hf, 16384, D))
        bufs = [t.contiguous() for t in (kq6, ks6, vq6, vs6)]
        q = randn(1, 1, hf * G, D, mul=Q_PEAK)
        cs_arg = torch.tensor(16000, dtype=torch.int32, device=dev)
        call = lambda: flash.full_cache_attention_q4(q, *bufs, cs_arg, bucket=16384)  # noqa: E731
        err, ratio, ok = _attn_tol_ok(call(), flash.full_cache_attention_q4_plain(q, *bufs, cs_arg, bucket=16384), True)
        require(ok, f"INT4 decode at hf={hf} disagrees with its plain version ({err})")
        nsplit, split_keys = flash.q4_decode_split_plan(16384, hf)
        nbytes = 2 * (2 * hf * G * D) + 2 * hf * 16001 * (D // 2 + 4)
        by_hf[hf] = dict(device_ms=cuda_graph_time_ms(call), ms=cuda_time_ms(call, iters=ITERS, warmup=1),
                         bound_ms=_bound(4 * D * hf * G * 16001, nbytes)[0], blocks=hf * nsplit,
                         split_keys=split_keys, err_over_tol=ratio)
        log(f"  full_cache_attention_q4.decode hf={hf} cs=16000: device {by_hf[hf]['device_ms']:.4f} ms, "
            f"rate {by_hf[hf]['ms']:.4f} ms, bound {by_hf[hf]['bound_ms']:.4f} ms, {hf * nsplit} blocks "
            f"of {split_keys} keys, err/tol {ratio:.3f}")
    rec.results["full_cache_attention_q4.decode_by_hf"] = by_hf
    del kq, ks, vq, vs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _profiled_window(fn):
    """Run fn under torch.profiler (host and device) and return (the events
    from the start of fn's marked range on, the window's wall ms). The
    profiler can lose the device records of the first launches after it
    starts (scripts/profiler_first_launches.py), so PREROLL_LAUNCHES tiny
    kernels go first and only events from the start of the window, a marked
    range after them, are kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL_LAUNCHES):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # the range on the host (the profiler may also draw it on the device timeline)
    start = min(e.time_range.start for e in events if e.name == WINDOW)
    return [e for e in events if e.time_range.start >= start and e.name != WINDOW], wall_ms


def _device_kernels(fn):
    """Names of the device activities (kernels, copies) one call of fn makes,
    from torch.profiler, after a call outside the window."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    events, _ = _profiled_window(fn)
    return [e.name for e in events if e.device_type == DeviceType.CUDA]


def _q4_decode_products(call, want, times):
    """The INT4 decode at the main path's shape with its two products (S = Q K^T,
    O += P V) on the tensor cores (mma.sync m16n8k16, as built) and on the CUDA
    cores (float32 FMAs, the variant build): device and rate ms of each, and
    the variant's agreement with the plain version."""
    from duo_attention_tpu_torch.ops import _build, flash
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms, cuda_time_ms

    kept = flash._lib_q4
    flash._lib_q4 = lambda: _build.load(FMA_VARIANT[0], flash._Q4_SIGNATURES, FMA_VARIANT[1])
    try:
        err, ratio, ok = _attn_tol_ok(call(), want, q4=True)
        require(ok, f"the FMA build of the INT4 decode disagrees with its plain version ({err})")
        fma = dict(ms=cuda_time_ms(call, iters=ITERS, warmup=1), device_ms=cuda_graph_time_ms(call),
                   max_abs_err=err, err_over_tol=ratio)
    finally:
        flash._lib_q4 = kept
    out = dict(mma=dict(ms=times[0], device_ms=times[1]), fma=fma)
    log(f"  INT4 decode products at cs=16000: mma.sync {times[1]:.4f} ms on the device ({times[0]:.4f} as "
        f"issued); float32 FMAs {fma['device_ms']:.4f} ({fma['ms']:.4f}), err/tol {ratio:.3f}")
    return out


# ---------------------------------------------------------------------------
# Phase 4-5: the model
# ---------------------------------------------------------------------------


def _counters():
    """The kernels' launch counters by name (ops/launches.py)."""
    from duo_attention_tpu_torch.ops import launches

    return {name: c for name, c in launches.counters().items() if c[1] != "cuda_calls"}


def _plain_functions():
    from duo_attention_tpu_torch.ops import launches

    return [fn for fn, attr in launches.counters().values() if attr == "cuda_calls"]


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    for fn in _plain_functions():
        fn.cuda_calls = 0


def read_counts():
    """Each kernel's launches, and the plain versions' calls on CUDA tensors."""
    out = {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}
    out["plain_cuda_calls"] = sum(fn.cuda_calls for fn in _plain_functions())
    return out


def _model_setup():
    from duo_attention_tpu_torch import (
        PRESETS, DuoConfig, load_attn_pattern, num_full_kv_heads_per_layer,
        sparsify_attention_heads,
    )

    cfg = PRESETS["Llama-3-8B-Instruct-Gradient-1048k"]
    heads, sink, recent = load_attn_pattern(os.path.join(REPO, "artifacts", "niah_8b", "pattern"))
    binary, sparsity = sparsify_attention_heads(heads, sparsity=0.5)
    nf = num_full_kv_heads_per_layer(binary)
    require(nf == EXPECTED_FULL_HEADS, f"pattern gave full heads {nf}")
    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=nf,
                    max_cache_size=MAX_CACHE, prefill_chunk_size=CHUNK)
    return cfg, duo, sparsity


def phase_end_to_end(params, cfg, duo, kv_quant="none"):
    """Drive DuoEngine.generate on the 16,000-token prompt in one format
    (``kv_quant`` "none": bf16 params and cache; "int4": W8A8 params and the
    INT4 cache) and check the launch counts, the cache and the tokens."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, kv_memory_bytes
    from duo_attention_tpu_torch.models import llama
    from duo_attention_tpu_torch.ops import launches

    q4 = kv_quant == "int4"
    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))
    engine.generate(ids[:, :300], max_new_tokens=2)  # warm up cuBLAS and the kernels' first launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    tokens, cache = engine.generate(ids, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()

    n_chunks = -(-PROMPT_LEN // CHUNK)
    hf_layers = sum(1 for n in duo.num_full_kv_heads if n > 0)
    hs_layers = sum(1 for n in duo.num_full_kv_heads if n < cfg.num_kv_heads)
    full = "full_cache_attention_q4" if q4 else "full_cache_attention"
    expected = dict.fromkeys(_counters(), 0)
    expected.update({
        full + ".prefill": n_chunks * hf_layers,
        full + ".decode": NEW_TOKENS * hf_layers,
        "streaming_cache_attention.prefill": n_chunks * hs_layers,
        "streaming_cache_attention.decode": NEW_TOKENS * hs_layers,
        # K and V rows in one launch (INT4: each quantized on the way)
        "write_q4_token" if q4 else "write_row": NEW_TOKENS * hf_layers,
        "write_streaming_rows": NEW_TOKENS * hs_layers,
        "plain_cuda_calls": 0,
    })
    if q4:  # 7 projections a layer and the head
        expected["w8a8_matmul.tiled"] = n_chunks * 7 * cfg.num_layers  # M = 4096, one launch a weight
        # M = 1: one launch for wq+wk+wv, wo, gate+up and down, and the head: 129 a step
        expected["w8a8_matmul.small"] = n_chunks + NEW_TOKENS * (4 * cfg.num_layers + 1)
    kv_bytes = kv_memory_bytes(cache)
    require(type(cache).__name__ == ("DuoCacheQ4" if q4 else "DuoCache"), f"cache is a {type(cache).__name__}")
    log(f"  launches {counts}")
    require(counts == expected, f"launch counts {counts} != expected {expected}")
    require(int(cache.length) == PROMPT_LEN + NEW_TOKENS, f"cache.length {int(cache.length)}")
    require(tokens.shape == (1, NEW_TOKENS), f"tokens shape {tokens.shape}")
    require(((tokens >= 0) & (tokens < cfg.vocab_size)).all(), "tokens out of range (overrun poison?)")
    del cache

    # the same path split in two, for TTFT and the decode rate, on a new engine (no
    # graph yet: the decode captures one, and what it allocates shows)
    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = engine.prefill(ids)
    first = torch.argmax(logits, dim=-1)
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    held = torch.cuda.memory_allocated()
    blocks_before = _allocated_blocks(torch.cuda.memory_snapshot())
    torch.cuda.memory._record_memory_history(max_entries=200000, stacks="python")
    t0 = time.perf_counter()
    again, cache = engine.decode_tokens(cache, first, NEW_TOKENS, length=PROMPT_LEN)
    torch.cuda.synchronize()
    # a new cache: its first step runs eagerly and the step is captured after it
    decode_ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    graph_bytes = torch.cuda.memory_allocated() - held  # the graph's pool, the decode scratch, the output
    new_blocks = _new_blocks(blocks_before, torch.cuda.memory._snapshot()["segments"])
    torch.cuda.memory._record_memory_history(enabled=None)
    log(f"  the decode left {len(new_blocks)} more blocks allocated, the largest: {json.dumps(new_blocks[:6])}")
    require(np.array_equal(again, tokens), "a second run of the same prompt gave other tokens")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  generate {PROMPT_LEN}+{NEW_TOKENS} tokens: {gen_s:.3f} s; TTFT {ttft_ms:.1f} ms; "
        f"decode {decode_ms:.2f} ms/token (capture included); peak memory {peak_gib:.2f} GiB (graph pool "
        f"included; the decode left {graph_bytes / 2**20:.1f} MiB more allocated); "
        f"KV cache {kv_bytes / 2**30:.3f} GiB ({type(cache).__name__})")

    # Decode on, on the same cache at the same bucket: the engine (graph replays),
    # then a loop of eager forward_chunk steps, NEW_TOKENS tokens each
    length = PROMPT_LEN + NEW_TOKENS
    token = torch.as_tensor(again[:, -1], device="cuda").long()
    bucket = engine.bucket_for(length + 2 * NEW_TOKENS + 16)
    require(bucket == engine.bucket_for(PROMPT_LEN + NEW_TOKENS), "the decode windows changed bucket")

    def graph_steps(n):
        nonlocal cache, length
        _, cache = engine.decode_tokens(cache, token, n, length=length)
        length += n

    def eager_steps(n):
        nonlocal cache, length
        tok = token
        with torch.no_grad():
            for _ in range(n):
                hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tok[:, None], 1, full_bucket=bucket)
                tok = torch.argmax(llama.logits_at(params, hidden, 0), dim=-1)
        length += n

    decode = {}
    for mode, steps_fn in (("graph", graph_steps), ("eager", eager_steps)):
        before = launches.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps_fn(NEW_TOKENS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
        counted = [a - b for a, b in zip(launches.snapshot(), before)]
        decode[mode] = dict(ms_per_token=ms, counted_launches=counted)
    per_token = [n // NEW_TOKENS for n in decode["graph"]["counted_launches"]]
    require(decode["graph"]["counted_launches"] == decode["eager"]["counted_launches"]
            and all(n == t * NEW_TOKENS for n, t in zip(decode["graph"]["counted_launches"], per_token)),
            f"kernel launches a token differ between the graph and the eager loop: {decode}")
    kernel_launches = {n: c for n, c in zip(launches.counters(), per_token) if c}
    log(f"  kernel launches a decode token, graph = eager (the counters): {kernel_launches}")
    torch.cuda.empty_cache()

    # where the device time goes: the prefill, and 8 decode steps each way on the same cache
    state = {}

    def prefill():
        state["cache"], state["logits"] = engine.prefill(ids)

    breakdown = {"prefill": device_breakdown(prefill), "decode_8_steps": device_breakdown(lambda: graph_steps(8)),
                 "decode_8_steps_eager": device_breakdown(lambda: eager_steps(8))}
    for window, b in breakdown.items():
        log(f"  profile {window}: {json.dumps(b)}")
    # what the device ran, by the profiler, against the counters: the graph's replays
    # launch every kernel the eager loop does, as many times as the counters say
    ran = {mode: breakdown[window]["kernels_ran"] for mode, window in
           (("graph", "decode_8_steps"), ("eager", "decode_8_steps_eager"))}
    counted = {name: 8 * n for name, n in kernel_launches.items()}
    require(ran["graph"] == ran["eager"] == counted,
            f"kernels the device ran in 8 decode steps (graph {ran['graph']}, eager {ran['eager']}) "
            f"differ from 8 times the counted launches a token ({counted})")
    log(f"  kernels the device ran in 8 decode steps, graph = eager = 8 x the counters: {ran['graph']}")
    for mode, window in (("graph", "decode_8_steps"), ("eager", "decode_8_steps_eager")):
        b = breakdown[window]
        decode[mode].update(device_ms_per_step=b["device_busy_ms"] / 8, idle_share=b["idle_share"],
                            host_launch_calls_per_step=b["host_launch_calls"] / 8,
                            device_activities_per_step=b["device_activities"] / 8,
                            copy_activities_per_step=b["copy_activities"] / 8)
        log(f"  decode, {mode}: {decode[mode]['ms_per_token']:.2f} ms/token, {b['device_busy_ms'] / 8:.3f} device "
            f"ms a step, idle {b['idle_share']:.3f} (profiled), {b['host_launch_calls'] / 8:.1f} launch calls "
            f"from the host a step, {b['device_activities'] / 8:.1f} device activities a step, of them "
            f"{b['copy_activities'] / 8:.1f} copies")
        # the W8A8 linears quantize inside the small-M kernel: no plain-torch quantization is left
        require(b["elementwise_quantize_kernels"] == 0,
                f"the {mode} decode ran {b['elementwise_quantize_kernels']} abs/round elementwise kernels")
    del state, cache
    torch.cuda.empty_cache()
    return dict(counts=counts, expected=expected, generate_s=gen_s, ttft_ms=ttft_ms, profile=breakdown,
                decode_ms_per_token=decode_ms, decode=decode, kernel_launches_per_token=kernel_launches,
                tokens=tokens[0, :16].tolist(), peak_memory_gib=peak_gib, decode_allocated_bytes=graph_bytes,
                decode_new_blocks=new_blocks[:20], kv_memory_bytes=kv_bytes)


def _allocated_blocks(segments):
    """The caching allocator's allocated blocks in a memory snapshot, by address."""
    out = {}
    for seg in segments:
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                out[blk.get("address", addr)] = (seg, blk)
            addr += blk["size"]
    return out


def _new_blocks(before, segments):
    """Blocks allocated in ``segments`` and not in ``before``, largest first:
    bytes, the segment's pool (a CUDA graph's private pool is not (0, 0)) and
    stream, and the innermost Python frames that allocated it (where memory
    history was recorded)."""
    new = []
    for addr, (seg, blk) in _allocated_blocks(segments).items():
        if addr in before:
            continue
        frames = [f"{os.path.basename(f.get('filename', '?'))}:{f.get('line', '?')} {f.get('name', '?')}"
                  for f in blk.get("frames", [])[:4]]
        new.append(dict(bytes=blk["size"], pool=str(seg.get("segment_pool_id")), stream=seg.get("stream"),
                        frames=frames))
    return sorted(new, key=lambda b: -b["bytes"])


def _kernel_kind(name):
    """The port's kernels by name (prefill_kernel<0> is full heads, <1>
    streaming; the bf16 full-head decode is a split kernel and its merge),
    cuBLAS matrix products, and everything else."""
    ours = {"prefill_kernel<0>": "full_cache_attention.prefill",
            "prefill_kernel<1>": "streaming_cache_attention.prefill",
            "stream_decode_kernel": "streaming_cache_attention.decode",  # before decode_kernel<, a part of its name
            "decode_kernel<": "full_cache_attention.decode",
            "decode_merge_kernel": "full_cache_attention.decode",
            "write_streaming_rows_kernel": "write_streaming_rows", "write_row_kernel": "write_row",
            "prefill_q4_kernel": "full_cache_attention_q4.prefill",
            "decode_q4_kernel": "full_cache_attention_q4.decode",
            "write_q4_token_kernel": "write_q4_token",
            "w8a8_tiled_kernel": "w8a8_matmul.tiled", "w8a8_small_mma_kernel": "w8a8_matmul.small"}
    compact = name.replace(" ", "")
    for key, kind in ours.items():
        if key in compact:
            return kind
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def device_breakdown(fn):
    """Run fn under torch.profiler: device milliseconds by kind of kernel,
    the window's wall time, and the share of it the device was idle (the
    profiler's own host cost inflates the wall time, so this idle share is
    an upper bound); the host's calls that put work on the device
    (HOST_LAUNCH_CALLS, by name) and the device activities (kernels, copies),
    among them the copies and the elementwise kernels of a plain-torch
    activation quantization (QUANTIZE_KERNELS);
    the port's kernels as the device ran them, by counter name (a split
    decode's merge kernel, launched with it, is not counted again).

    Read from a marked range behind a pre-roll, as ``_profiled_window``
    says."""
    from torch.autograd import DeviceType

    events, wall_ms = _profiled_window(fn)
    by_kind, other, ran = {}, {}, {}
    host_calls = device_activities = copies = quantizing = 0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            host_calls += e.name in HOST_LAUNCH_CALLS
            continue
        device_activities += 1
        copies += "copy" in e.name.lower()  # copy kernels and memcpy activities
        quantizing += any(k in e.name for k in QUANTIZE_KERNELS)
        ms = e.time_range.elapsed_us() / 1e3
        kind = _kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        if kind in REPLACES and "decode_merge_kernel" not in e.name:
            ran[kind] = ran.get(kind, 0) + 1
        if kind == "other":
            require(not any(k in e.name for k in FLASH_CU_KERNELS),
                    f"kernel {e.name!r} of flash.cu is filed under 'other'")
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + ms
    busy = sum(by_kind.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=(1 - busy / wall_ms) if busy else None,
                host_launch_calls=host_calls, device_activities=device_activities, copy_activities=copies,
                elementwise_quantize_kernels=quantizing,
                by_kind_ms=by_kind, kernels_ran=ran,
                top_other_ms=dict(sorted(other.items(), key=lambda kv: -kv[1])[:6]))


def phase_kernel_vs_plain(params, cfg, duo, kv_quant="none", layers=4, prompt=6000, steps=8):
    import torch

    from duo_attention_tpu_torch.cache import init_cache, init_cache_q4
    from duo_attention_tpu_torch.engine import _next_bucket
    from duo_attention_tpu_torch.models import llama

    cfg4 = dataclasses.replace(cfg, num_layers=layers)
    duo4 = dataclasses.replace(duo, num_full_kv_heads=duo.num_full_kv_heads[:layers])
    params4 = dict(params, layers=params["layers"][:layers])
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt))
    dev = torch.device("cuda")
    new_cache = init_cache_q4 if kv_quant == "int4" else init_cache

    def run(plain, feed=None):
        """Prefill, then ``steps`` decode steps fed ``feed`` (or, when None,
        each step's own argmax). Returns (logits [1 + steps, vocab], fed ids)."""
        cache = new_cache(cfg4, duo4, 1, torch.bfloat16, dev)
        with torch.no_grad():
            for off in range(0, prompt, CHUNK):
                chunk = ids[:, off : off + CHUNK]
                n = chunk.shape[1]
                chunk = np.pad(chunk, ((0, 0), (0, CHUNK - n)))
                hidden, cache = llama.forward_chunk(
                    params4, cfg4, duo4, cache, torch.as_tensor(chunk, device=dev), n,
                    full_bucket=min(_next_bucket(off + CHUNK), MAX_CACHE), plain=plain)
            out = [llama.logits_at(params4, hidden, n - 1, plain=plain)]
            fed = []
            bucket = min(_next_bucket(prompt + steps), MAX_CACHE)
            for i in range(steps):
                t = int(torch.argmax(out[-1])) if feed is None else feed[i]
                fed.append(t)
                hidden, cache = llama.forward_chunk(
                    params4, cfg4, duo4, cache, torch.tensor([[t]], device=dev), 1,
                    full_bucket=bucket, plain=plain)
                out.append(llama.logits_at(params4, hidden, 0, plain=plain))
        return torch.cat(out), fed

    # the kernel path decodes greedily; the plain path is fed the same tokens
    kern, feed = run(False)
    plain, _ = run(True, feed)
    err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    # where the two argmaxes differ: the plain path's gap between its top two
    # logits there, beside that position's largest |dlogit|
    top2 = plain.float().topk(2, dim=-1).values
    differ = [dict(position=i, plain_top2_gap=float(top2[i, 0] - top2[i, 1]),
                   max_abs_logit_err=float((kern[i] - plain[i]).abs().max()))
              for i in range(len(kern)) if int(kern[i].argmax()) != int(plain[i].argmax())]
    # Bound: 5% of the largest plain logit, plus 0.05 — bf16 activations
    # through 4 layers, where the two paths round attention differently. In
    # W8A8KV4 the int8 products are bitwise the same in both paths, but each
    # such difference can move an int8 activation to the next step, so the
    # bound is twice as wide there.
    bound = (0.1 if kv_quant == "int4" else 0.05) * scale + 0.05
    log(f"  kernel vs plain, {layers} layers, {prompt}-token prompt + {steps} steps: max |dlogit| "
        f"{err:.4f} (bound {bound:.4f}, max |logit| {scale:.3f}); argmax agreement {agree}/{steps + 1}"
        + (f"; where they differ: {json.dumps(differ)}" if differ else ""))
    require(bool(torch.isfinite(kern).all()), "kernel-path logits not finite")
    require(err <= bound, f"kernel path differs from plain path: {err} > {bound}")
    counts = read_counts()
    require(counts["plain_cuda_calls"] > 0, "the plain path made no plain-version call")
    return dict(max_abs_logit_err=err, bound=bound, max_abs_logit=scale,
                argmax_agree=agree, positions=steps + 1, argmax_differ=differ)


# ---------------------------------------------------------------------------
# Phase 8: continuous-batching serving
# ---------------------------------------------------------------------------


def _top2_margins(engine, params, cfg, duo, prompt, stream):
    """The isolated run's top-2 logit gap before each token of ``stream``:
    a prefill on a new cache, then eager forward_chunk steps fed the stream
    (teacher-forced). Returns [len(stream)] floats."""
    import torch

    from duo_attention_tpu_torch.models import llama

    cache, logits = engine.prefill(prompt[None])
    bucket = engine.bucket_for(len(prompt) + len(stream))
    gaps = []
    with torch.no_grad():
        for t in range(len(stream)):
            top = logits.float().topk(2, dim=-1).values[0]
            gaps.append(float(top[0] - top[1]))
            if t + 1 < len(stream):
                tok = torch.tensor([[stream[t]]], device="cuda")
                hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tok, 1, full_bucket=bucket)
                logits = llama.logits_at(params, hidden, 0)
    return gaps


def _pool_window(engine, bucket, sample):
    """8 replays of the pool's captured step (every slot set active) under
    the profiler; the kernels the device ran must equal 8 times the launch
    counters' movement a step. Returns the window's device breakdown."""
    from duo_attention_tpu_torch.ops import launches

    graph, _ = engine.pool_graph(bucket, sample)
    engine._active.fill_(True)
    b = device_breakdown(lambda: [graph.replay() for _ in range(8)])
    counted = {name: 8 * d for name, d in zip(launches.counters(), graph.delta) if d}
    require(b["kernels_ran"] == counted, f"pool step (bucket {bucket}, sampled {sample}): the device ran "
            f"{b['kernels_ran']}, 8 x the counters give {counted}")
    b["device_ms_per_step"] = b["device_busy_ms"] / 8
    return b


def _pool_steps(engine, bucket, label):
    """The greedy and the sampled pool step at ``bucket``: device ms a step
    of each and the sampled step's extra."""
    greedy, sampled = _pool_window(engine, bucket, False), _pool_window(engine, bucket, True)
    extra = sampled["device_ms_per_step"] - greedy["device_ms_per_step"]
    log(f"  {label} pool step, bucket {bucket}: greedy {greedy['device_ms_per_step']:.3f} device ms a step, "
        f"sampled {sampled['device_ms_per_step']:.3f} (+{extra:.3f}); idle {greedy['idle_share']:.3f} / "
        f"{sampled['idle_share']:.3f}; kernels of 8 replays = 8 x the counters: {greedy['kernels_ran']}; "
        f"device activities a step {greedy['device_activities'] / 8:.1f} / {sampled['device_activities'] / 8:.1f}; "
        f"sampled window's largest other kernels (ms over 8): {json.dumps(sampled['top_other_ms'])}")
    return dict(greedy=greedy, sampled=sampled, sampled_extra_ms=extra)


def _serve_once(params, cfg, duo, kv_quant, prompts, max_new, sampling, stops, slots=SERVE_SLOTS):
    """One ServingEngine run of the prompts. Returns (engine, tokens by rid, wall s)."""
    import torch

    from duo_attention_tpu_torch import Request, ServingEngine

    engine = ServingEngine(params, cfg, duo, max_batch_size=slots, kv_quant=kv_quant,
                           decode_burst=SERVE_BURST, device="cuda", timing=True)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt_ids=prompt, max_new_tokens=max_new, sampling=sampling.get(rid),
                              stop_token_ids=stops.get(rid, ())))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(len(finished) == len(prompts) and all(r.done for r in finished), "a request did not finish")
    return engine, {r.rid: list(r.generated) for r in finished}, wall


def _stop_choice(streams, prefer):
    """Where a stop token ends a request mid-stream: the first token of its
    stream, past the first burst where it can be (else at index 1 or later),
    that does not occur earlier in the stream. Request ``prefer`` first, then
    the others from the last down (a stream of one repeated token has none).
    Returns (rid, index of the stop token)."""
    for rid in [prefer] + sorted((r for r in streams if r != prefer), reverse=True):
        s = streams[rid]
        new = [t for t in range(1, len(s)) if s[t] not in s[:t]]
        if new:
            return rid, next((t for t in new if t > SERVE_BURST), new[0])
    raise SmokeFailure(f"no served stream has a token, past its first, that it did not emit before: {streams}")


def phase_serving(params, cfg, duo, kv_quant, lens, max_new, sampling):
    """ServingEngine over a pool of SERVE_SLOTS slots at the smoke geometry:
    more requests than slots, prompts that take several admission chunks
    between decode bursts, greedy and sampled rows, one request with a stop
    token (``_stop_choice`` over a stop-free run's streams). Requires that
    every request finishes, that the stopped request's stream is its
    stop-free stream cut just before the stop token (the run is the
    stop-free one until the burst that emits it), that a second run on a
    new engine gives the same tokens, that each greedy request's first token
    is its isolated DuoEngine.generate first token and its stream the
    isolated stream up to the first near-tie (top-2 gap < NEAR_TIE) of the
    isolated run, and that 8 replays of the pool step launch 8 times the
    counters' kernels."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, kv_memory_bytes
    from duo_attention_tpu_torch.evals import serving_bench

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    greedy = [i for i in range(len(lens)) if sampling.get(i) is None or sampling[i].is_greedy]
    single = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant, decode_burst=SERVE_BURST)
    iso, gaps = {}, {}
    t0 = time.perf_counter()
    for i in greedy:
        iso[i] = single.generate(prompts[i][None], max_new)[0][0].tolist()
        gaps[i] = _top2_margins(single, params, cfg, duo, prompts[i], iso[i])
    iso_s = time.perf_counter() - t0
    _, free, _ = _serve_once(params, cfg, duo, kv_quant, prompts, max_new, sampling, {})
    stop_rid, stop_at = _stop_choice(free, len(lens) - 1)
    stop = free[stop_rid][stop_at]
    stops = {stop_rid: (stop,)}

    reset_counts()
    engine, served, wall = _serve_once(params, cfg, duo, kv_quant, prompts, max_new, sampling, stops)
    counts = read_counts()
    require(counts["plain_cuda_calls"] == 0, f"the serving path called plain versions: {counts}")
    summary = serving_bench.summarize(engine, wall, lens)
    _, again, wall2 = _serve_once(params, cfg, duo, kv_quant, prompts, max_new, sampling, stops)
    require(again == served, f"a second run on a new ServingEngine gave other tokens: {again} vs {served}")

    # the stopped request ends just before its stop token, which the burst emitted mid-way
    require(served[stop_rid] == free[stop_rid][:stop_at],
            f"request {stop_rid} with stop token {stop} (index {stop_at} of its stop-free stream "
            f"{free[stop_rid]}) served {served[stop_rid]}")
    others_as_free = [i for i in served if i != stop_rid and served[i] == free[i]]
    log(f"  request {stop_rid}: stop token {stop}, index {stop_at} of its stop-free stream, in burst "
        f"{(stop_at - 1) // SERVE_BURST + 1} at step {(stop_at - 1) % SERVE_BURST + 1} of {SERVE_BURST}; served "
        f"{len(served[stop_rid])} tokens; the other requests' streams as in the stop-free run: {others_as_free}")
    agreement = {}
    for i in greedy:
        tie = next((t for t, g in enumerate(gaps[i]) if g < NEAR_TIE), len(gaps[i]))
        prefix = next((t for t, (a, b) in enumerate(zip(served[i], iso[i])) if a != b), min(len(served[i]), len(iso[i])))
        diverged = prefix < len(served[i])
        agreement[i] = dict(agreeing_prefix=prefix, first_near_tie=tie, served=len(served[i]),
                            gap_at_first_near_tie=gaps[i][tie] if tie < len(gaps[i]) else None,
                            gap_at_divergence=gaps[i][prefix] if diverged else None)
        log(f"  request {i} (prompt {lens[i]}): served {len(served[i])} tokens, agrees with its isolated run for "
            f"{prefix}" + (f" (isolated top-2 gap there {gaps[i][prefix]:.4f})" if diverged else "")
            + f"; its first near-tie (top-2 gap < {NEAR_TIE}) at {tie}"
            + (f" (gap {gaps[i][tie]:.4f})" if tie < len(gaps[i]) else " (none)"))
        require(served[i][0] == iso[i][0], f"request {i}: first token {served[i][0]}, isolated {iso[i][0]}")
        require(prefix >= min(tie, len(served[i])), f"request {i} diverged at {prefix} before its first near-tie {tie}")
        # the same context up to the divergence: the served step flipped a token only where the
        # isolated run had a near-tie
        require(not diverged or agreement[i]["gap_at_divergence"] < NEAR_TIE,
                f"request {i} diverged at {prefix}, where the isolated top-2 gap is {agreement[i]['gap_at_divergence']}")
    bucket = max(b for b, _ in engine._graphs)
    steps = _pool_steps(engine, bucket, f"B={SERVE_SLOTS}")
    kv = kv_memory_bytes(engine.cache)
    captures = engine.graph_captures()
    log(f"  pool KV {kv / 2**30:.3f} GiB; {len(captures)} captures, {sum(c['seconds'] for c in captures):.3f} s: "
        f"{json.dumps(captures)}; wall {wall:.2f} s (second run {wall2:.2f} s), isolated runs {iso_s:.1f} s")
    log(f"  aggregate {json.dumps(summary['aggregate'])}")
    log(f"  per-token latency {json.dumps(summary['per_token_latency_s'])}; admission stall "
        f"{json.dumps(summary['admission_stall_s'])}; TTFT {json.dumps(summary['requests'])}")
    del engine
    torch.cuda.empty_cache()
    return dict(counts=counts, tokens={i: t[:16] for i, t in served.items()}, agreement=agreement,
                stop=dict(rid=stop_rid, token=stop, index=stop_at, served=len(served[stop_rid]),
                          others_as_stop_free=others_as_free), kv_memory_bytes=kv,
                captures=captures, pool_steps=steps, isolated_s=iso_s, second_wall_s=wall2,
                **{k: summary[k] for k in ("aggregate", "per_token_latency_s", "admission_stall_s", "requests")})


def _serve_sampling():
    from duo_attention_tpu_torch import SamplingParams

    return {1: SamplingParams(temperature=0.8, top_p=0.95, top_k=0, seed=1),
            4: SamplingParams(temperature=0.8, top_p=0.95, top_k=50, seed=4),
            3: SamplingParams(temperature=0.0)}


def phase_serving_bench():
    """evals/serving_bench.py at its defaults (8 slots, 8 prompts of 32,256
    tokens, 256 new tokens each, bursts of 16, chunks of 4096, sparsity 0.5),
    without its warm-up pass; then the B=8 pool step, greedy and sampled."""
    import torch

    from duo_attention_tpu_torch.evals import serving_bench

    args = serving_bench.build_parser().parse_args(
        ["--no-warmup-run", "--out-dir", os.path.join(REPO, "chiprun_out", "serving")])
    t0 = time.perf_counter()
    report, engine = serving_bench.run_bench_engine(args)
    secs = time.perf_counter() - t0
    agg = report["aggregate"]
    require(agg["total_generated_tokens"] == args.slots * args.max_new,
            f"the bench generated {agg['total_generated_tokens']} tokens, not {args.slots * args.max_new}")
    require(all(r["generated"] == args.max_new for r in report["requests"]), "a bench request fell short")
    log(f"  aggregate {json.dumps(agg)}")
    log(f"  per-token latency {json.dumps(report['per_token_latency_s'])}; admission stall "
        f"{json.dumps(report['admission_stall_s'])}")
    log(f"  TTFT {json.dumps(report['requests'])}")
    steps = _pool_steps(engine, max(b for b, _ in engine._graphs), f"B={args.slots}")
    del engine
    torch.cuda.empty_cache()
    return dict(seconds=secs, pool_steps=steps, **{k: v for k, v in report.items() if k != "trace"})


# ---------------------------------------------------------------------------


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "duo_attention_tpu_torch")):
        print("FAIL: the duo_attention_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    record = {}
    rec = Recorder()
    try:
        log("phase 1: device")
        smi = phase_device()
        log(smi)
        record["nvidia_smi"] = smi
        log("phase 2: build")
        record["build_s"] = phase_build()
        log("phase 3: kernels vs plain versions")
        phase_kernels(rec)
        phase_kernels_w8a8kv4(rec)
        record["kernels"] = rec.results

        from duo_attention_tpu_torch.models.llama import init_params
        from duo_attention_tpu_torch.ops.quant import init_params_w8a8_random

        cfg, duo, sparsity = _model_setup()
        formats = (("bf16", "none", lambda: init_params(cfg, seed=0, device="cuda")),
                   ("w8a8kv4", "int4", lambda: init_params_w8a8_random(cfg, seed=0, device="cuda")))
        phase = 4
        for fmt, kv_quant, make_params in formats:
            t0 = time.perf_counter()
            params = make_params()
            torch.cuda.synchronize()
            log(f"{fmt} weights: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params, "
                f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB, "
                f"in {time.perf_counter() - t0:.1f} s; sparsity {sparsity:.3f}, full heads "
                f"{sum(duo.num_full_kv_heads)}/{cfg.num_layers * cfg.num_kv_heads}")
            log(f"phase {phase}: end to end, {fmt}, DuoEngine.generate")
            record["end_to_end_" + fmt] = phase_end_to_end(params, cfg, duo, kv_quant)
            log(f"phase {phase + 1}: kernel path vs plain path, {fmt}")
            record["kernel_vs_plain_" + fmt] = phase_kernel_vs_plain(params, cfg, duo, kv_quant)
            phase += 2
            t0 = time.perf_counter()
            if kv_quant == "int4":
                log("phase 8a: serving, W8A8KV4 (ServingEngine, 4 slots, 6 requests)")
                record["serving_" + fmt] = phase_serving(params, cfg, duo, kv_quant, SERVE_LENS, SERVE_NEW,
                                                         _serve_sampling())
            else:  # while the bf16 weights are alive: a short run puts their kernels on a serving path
                log("phase 8c: serving, bf16 (ServingEngine, 4 slots, 3 requests)")
                record["serving_" + fmt] = phase_serving(params, cfg, duo, kv_quant, SERVE_LENS_BF16, 24,
                                                         {1: _serve_sampling()[1]})
            record["serving_" + fmt]["phase_s"] = time.perf_counter() - t0
            log(f"  serving phase, {fmt}: {record['serving_' + fmt]['phase_s']:.1f} s")
            del params  # free this format's weights before the next one's are made
            torch.cuda.empty_cache()
        log("phase 8b: serving bench (evals/serving_bench.py, W8A8KV4, defaults, no warm-up pass)")
        t0 = time.perf_counter()
        record["serving_bench"] = phase_serving_bench()
        log(f"  serving bench phase: {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    runs = {fmt: record["end_to_end_" + fmt]["counts"] for fmt, _, _ in formats}
    runs.update({"serving_" + fmt: record["serving_" + fmt]["counts"] for fmt, _, _ in formats})
    line = []
    for name, cases in rec.results.items():
        if name not in REPLACES:
            continue
        head = next(c for c in cases if c["main"])  # the main path's shape
        launches = {fmt: counts[name] for fmt, counts in runs.items()}
        require(sum(launches.values()) > 0, f"{name}: no launch on either main path")
        line.append(dict(
            name=name, route="cuda",
            source="duo_attention_tpu_torch/csrc/" + SOURCES[name.split(".")[0]],
            replaces=REPLACES[name], launches=sum(launches.values()), launches_by_format=launches,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], device_ms=head["device_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], library_device_ms=head["library_device_ms"],
            case=head["case"], **({"library_calls": head["library_calls"]} if "library_calls" in head else {}),
        ))
        if name == "full_cache_attention_q4.decode":  # its products on the CUDA cores instead (variant build)
            fma = rec.results["full_cache_attention_q4.decode_products"]["fma"]
            line[-1].update(fma_ms=fma["ms"], fma_device_ms=fma["device_ms"])
    require(len(line) == len(REPLACES), f"kernels line has {len(line)} entries, expected {len(REPLACES)}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(record["nvidia_smi"])
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _leaves(params):
    for key, val in params.items():
        if key == "layers":
            for layer in val:
                yield from layer.values()
        else:
            yield val


if __name__ == "__main__":
    sys.exit(main())
