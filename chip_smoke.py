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
     window, decode split plans with one, full, ragged and empty splits, the
     bf16 full-head decode's partition (even shares, checked) at B = 1 and 4
     and at the serving pool's shape (16 rows, 5 live, 11 with no query, hf
     1, 4 and 8), and sweeps of the streaming decode's plans at each
     main-path head count, B = 1 and 4; queries
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
     32,500 beside short rows (bucket 32768). Then every attention kernel's
     head_dim-64 instantiation and the three writes at D = 64, at 10b's
     shapes (the constructed circuit's: 2 full and 2 streaming KV heads of
     one query head, chunks of 256, a cache of 1,536, sink 16, recent 64)
     and at the 8B path's shapes with D = 64, recorded as ``<kernel>.d64``.
     And the shapes tensor parallelism gives them (phase 12, TP = 2): every
     attention kernel, prefill and decode, over 2 KV heads of a rank (query
     heads 8); the small-M product's int8-input mode with a given (cross-
     rank) x scale at wo's and w_down's local depths (K = 2,048 and 7,168),
     M = 1 and 8, and the tiled product at K = 2,048, M = 4,096, float32 out.
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
  9. the eval stack, after every earlier format's weights are freed: the
     constructed retrieval circuit grafted into the 8B geometry
     (evals/niah.py::build_model("constructed-8b"): W8A8, built on the card),
     artifacts/niah_8b/pattern at sparsity 0.5, reordered, INT4 cache in bf16,
     sink 64, recent 256, single_bucket engines:
     9a NIAHTester, bucket 131,200 (the smallest multiple of 128 at or above
        131,072 + 8), chunk 4096, the CLI's needle (_NAMES[7], _CODE_WORDS[9:12]),
        8 generated tokens: ctx 32,768 at 9 depths with the trained and with
        the inverted pattern, one 131,072 cell and one 32,768 cell in
        simulation mode (16 tokens), trained; then the same 32k cell in a
        bucket of 32,896 (TTFT and steady decode in both buckets: what the
        keys past the live length cost). Requires word overlap 1.0 in every
        trained cell, a mean <= 0.25 over the inverted interior depths, and a
        launch of kernels 2 and 4-7; prints the grid, each cell's latency and
        prefill time, the 131k cell's TTFT, ms/token and KV bytes;
     9b longbench.predict_task and score_file on trec and lsht (8 records
        each), with scripts/run_longbench_tpu.sh's settings (prompt 8000,
        cache 16384, chunk 2048, 16 simulated tokens, stop at "."), trained
        (each >= 87.5) and inverted (each <= 25);
     9c evals/efficiency.py at the 8B geometry (random int8 weights, 32
        layers) at 32k, sparsity 0.0 and 0.5: bench_prefill (median of 3),
        bench_decode (64 steps, best of 3), bench_serving (B = 8); every
        cache's bytes must equal their reckoning from the shapes, and the
        serving pool's at 0.5 must be below 0.0's. Prints the ratios.
     Each sub-phase's seconds are printed; its launches join the kernels line.
 10. gate training (train/trainer.py, ops/blockwise.py, the W8A8 linear's
     straight-through backward), after phase 9's weights are freed:
     10a GateTrainer on constructed-8b (W8A8, built on the card), B = 1, sink
        64, recent 256, lr 0.05, reg 0.05, warmup 4, block 1024, 4 passkeys:
        40 steps at 1,024-2,048 tokens padded to 2,048 (every step's loss
        finite, gates in [0, 1], 21 tiled W8A8 launches a layer and no plain
        product; one step profiled, its tiled kernels equal to the counter,
        its device time by kind); the gates above 0.5 must be exactly the
        circuit's two retrieval heads (artifacts/niah_8b/pattern_gt). The
        pattern is written (finalize), read back, made binary at sparsity 0.5
        (reported: equal to phase 9's or not) and deployed: one NIAH cell at
        32k, depth 50%, phase 9's engine, word overlap 1.00. Then 3 steps at
        1,024-4,096 tokens padded to 4,096 (the TPU recipe's length) for the
        time a step and the peak memory, a 4th profiled;
     10b evals/accuracy_loop.py::run_loop with 80 gate steps and the JAX
        loop's other defaults (B = 8, 16 samples) on the 64-wide constructed
        circuit of the TPU's record (artifacts/accuracy_loop/report.json),
        through the head_dim-64 kernels: its gates separated as
        tests/test_accuracy_loop.py:99-123 requires (retrieval heads layer
        1, heads 0 and 1, > 0.6, local < 0.35, a gap > 0.4), word overlap
        >= 0.95 full and trained, >= 0.90 their W8A8KV4 variants, <= 0.25
        inverted, printed beside the record's; its launches are the
        ``.d64`` rows' of the kernels line.
 11. Mixtral-8x7B's MoE MLP (models/llama.py::_moe_mlp, dense dispatch) at
     the published width (mistralai/Mixtral-8x7B-v0.1's config.json through
     config_from_hf_dict), depth cut to 8 of 32 layers, random weights, 4 of
     8 KV heads full in every layer, sink 64, recent 256, in bf16 and in
     W8A8KV4 (init_params_w8a8: attention projections and head int8, router
     float32, experts bf16): phase 4's DuoEngine run (16,000-token prompt,
     chunk 4096, 64 greedy tokens; launch counts, TTFT, decode ms/token,
     idle share, peak memory), the captured decode's tokens equal to an
     eager loop's, phase 5 over 4 layers (the plain path's router handed
     the kernel path's experts: _PinnedRouting), a ServingEngine run of 3
     requests held to isolated runs (up to the first logit near-tie or
     router near-tie, ROUTER_NEAR_TIE), and the device ms a step by kind (expert
     products, router and combine, attention kernels, W8A8 products, other)
     beside the bounds of dense dispatch (every expert read a token; every
     expert multiplied a prompt token).
 12. tensor parallelism (duo_attention_tpu_torch/parallel/, torch.distributed),
     each sub-phase's ranks spawned processes that build their slices of the
     weights from seed 0 layer by layer (no rank holds the whole model), after
     the one-process reference has freed its weights. One card runs both ranks
     of TP = 2, through gloo (NCCL refuses two ranks on one GPU): none of their
     times is a TP speed figure.
     12a TP = 2 over gloo, the 8B width and pattern cut to the first TP_LAYERS
        layers (3 of them head-sharded), bf16 then W8A8KV4, an 8,000-token
        prompt (two chunks) and 32 eager greedy tokens: fed the one-process
        engine's greedy tokens (teacher-forced), the logits before every one
        of them (the prefill's last, then every decode step's) within phase
        5's bound of the one-process engine's, and the ranks' own tokens
        equal up to its first top-2 gap below NEAR_TIE; per rank TTFT, ms/token,
        peak memory, KV bytes equal to their reckoning from the rank's heads,
        the collectives of a step equal to parallel.mesh.collectives_per_step,
        the kernel launches of a step (counters) equal to the profiler's over 2
        steps;
     12b TP = 1 over NCCL (one process), phase 4's workload in both formats
        through the mesh path with graph capture: its 128 tokens bitwise equal
        to the no-mesh engine's, and the collectives a replayed token (captured
        with the step) equal to the reckoning; graph ms/token of both; then
        ServingEngine(mesh=) over the same one-rank NCCL mesh, its pool steps
        captured with their collectives: 12c's requests served bit for bit
        as the no-mesh pool serves them, and each captured pool step's
        collectives equal to the reckoning;
     12c ServingEngine(mesh=) at TP = 2, W8A8KV4, on 12a's ranks: 3 requests
        (6,000 / 1,500 / 3,000 tokens, 24 new each, one sampled): every token
        of a greedy stream within NEAR_TIE of the top logit of the isolated TP
        engine fed that stream (teacher-forced), and the streams equal to
        that engine's own up to its first near-tie;
     12d expert parallelism: Mixtral-8x7B's width cut to 2 layers at TP = 2
        (4 experts a rank), bf16: the prefill logits of a 2,000-token prompt
        within phase 5's bound of the one-process run's, the router pinned to
        its experts (_PinnedRouting);
     and parallel/dryrun.py's dry runs (dryrun_step) on 2 ranks of the card,
     its pipeline and gate-training steps among them.
     A rank that fails or hangs fails the run.
 13. pipeline stages, gate-training layouts and the 1M-token decode
     (parallel/pipeline.py, ulysses.py, fsdp.py; train/trainer.py on a mesh;
     parallel/dryrun.py::dryrun_1m_decode). Stages and ranks share the one card:
     none of their times is a PP, SP or TP speed figure.
     13a (run beside phases 4 and 6, on their weights): PipelinedEngine, PP = 2
        (16 + 16 layers), both stages on the card, phase 4's prompt and 64
        tokens in both formats: the prefill logits and the tokens bitwise
        DuoEngine's in the same buckets (else phase 5's bound and tokens up to
        the first near-tie, and the run says so), launch counts as phase 4
        reckons them, each stage's KV bytes equal to their reckoning, launches
        a token (counters) equal to the profiler's over 8 steps; TTFT, eager
        ms/token;
     13b evals/niah.py's CLI with --pp 2, unquantized as JAX's --pp requires:
        constructed-8b is built only in W8A8, so the 64-wide long-range circuit
        (constructed-long, head_dim 64, bf16 on the card) with its trained
        pattern (artifacts/accuracy_loop_long/pattern) at sparsity 0.5, 32k
        context at depths 0/50/100%: word overlap 1.00 in every cell, the
        responses equal to the one-device CLI's; its launches are .d64 rows';
     13c GateTrainer on a (data 1, seq 2) mesh over gloo (Ulysses), then with
        FSDP: constructed-8b in W8A8 cut to 8 of its 32 layers (the script's
        time: SP13_LAYERS), 2 steps of 2,048
        tokens (1,024 a rank) from gates 0.6: losses and gates after each step
        equal to the one-process step with JAX's N-scaled gradient within a
        bound from two one-process runs (block 1024 and 512), the collectives
        a step equal to train/trainer.py::collectives_per_step, FSDP's peak
        memory a rank below the replicated one's; s a step;
     13d dryrun_1m_decode(4): one decode step against the true 1,048,576-slot
        INT4 cache on 4 gloo ranks of the card, finite logits, each rank's KV
        bytes equal to their reckoning, held to the same step in one process
        within phase 5's bound.
     Phase 3 also holds the kernels at phase 13's new shapes: the tiled
     product at M = 1,024 (13c's local length) at the five 8B weight shapes,
     and the INT4 decode and the streaming decode at 13d's span (one KV head
     a rank, bucket 1,048,576), the INT4 buffers' offsets checked against
     int32 and the decode's split plan against its 32 merge slots.
Then one JSON line of per-kernel numbers and, last, the device line. A
detailed record goes to chiprun_out/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import dataclasses
import gc
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
# Phase 9, the eval stack: NIAH at 32k over 9 depths (8 generated tokens, the CLI's budget for a
# 3-word answer), one 131k cell and one 32k cell in simulation mode, all in a single bucket of
# the smallest max_cache_size the cache accepts (a multiple of 128) at or above 131,080; one
# 32k cell in a bucket just above 32k for the cost of the dead keys; LongBench as
# scripts/run_longbench_tpu.sh runs it; efficiency at 32k, every head full and half of them.
EVAL_CTX, NIAH_LONG_CTX, EVAL_DEPTHS, EVAL_GEN, EVAL_SIM, EVAL_STEADY_STEPS = 32768, 131072, 9, 8, 16, 64
NIAH_MAX_CACHE = -(-(NIAH_LONG_CTX + EVAL_GEN) // 128) * 128
NIAH_SMALL_CACHE = -(-(EVAL_CTX + EVAL_GEN) // 128) * 128
LB_TASKS, LB_PROMPT, LB_MAX_CACHE, LB_CHUNK, LB_SIM = ("trec", "lsht"), 8000, 16384, 2048, 16
EFF_SPARSITIES, EFF_BATCH = (0.0, 0.5), 8
# the kernels every eval run must launch: rows 2 and 4-7 of the TPU kernel table
EVAL_KERNELS = ("streaming_cache_attention.prefill", "streaming_cache_attention.decode", "write_streaming_rows",
                "write_q4_token", "full_cache_attention_q4.prefill", "full_cache_attention_q4.decode",
                "w8a8_matmul.tiled", "w8a8_matmul.small")
# Phase 10, gate training: 10a's recipe is tests/test_graft_8b.py:141's (lr, reg, warmup, 40 steps, B = 1
# here) with scripts/run_niah_8b_tpu.sh's sink/recent (SINK, RECENT), 4 passkeys and block 1024;
# contexts 1,024-2,048 padded to 2,048, and the TPU recipe's 1,024-4,096 padded to 4,096 for the
# time a step. Each layer runs 7 tiled W8A8 products in the teacher, 7 in the student and 7 again
# in the student's recompute (per-layer remat).
TRAIN_STEPS, TRAIN_TIME_STEPS, TRAIN_CTX, TRAIN_PAD, TRAIN_LONG_PAD = 40, 3, (1024, 2048), 2048, 4096
TRAIN_LR, TRAIN_REG, TRAIN_WARMUP, TRAIN_PASSKEYS, TRAIN_BLOCK, TILED_PER_LAYER = 0.05, 0.05, 4, 4, 1024, 21
# 10b: tests/test_accuracy_loop.py:99-123's length; at the JAX default of 600 steps 10b took 266 s on an H100
LOOP_GATE_STEPS = 80
NEAR_TIE = 0.25  # top-2 logit gap: about twice phase 7's largest |dlogit| on the H100 (0.1199)
# A MoE router's near-tie: the gap between its k-th and (k+1)-th expert logits, below which
# another product's rounding (a pool step at B = 4 against B = 1) may pick the other expert
ROUTER_NEAR_TIE = 0.02
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
# the attention kernels' and the writes' head_dim-64 instantiations (phase 3 at D = 64, launched by 10b)
REPLACES.update({name + ".d64": where for name, where in list(REPLACES.items()) if not name.startswith("w8a8")})
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
# Gate training's shapes (10a): every projection of a layer at M = B*S on the tiled route.
TRAIN_GEMM_LABELS = ("wq/wo", "wk/wv", "gate/up", "down")
# 10b's W8A8KV4 eval on the constructed circuit (hidden 256, 4 heads of 64, intermediate 64; the
# head stays bf16): prefill chunks of 256 and a ragged tail on the tiled route, and the decode step's
# groups at M = 1 on the small-M route; its engines' chunk and cache (accuracy_loop.run_loop).
LOOP_GEMM_SHAPES = {"loop wq/wk/wv/wo": (256, 256), "loop gate/up": (64, 256), "loop down": (256, 64)}
LOOP_PREFILL_MS = (256, 136)
LOOP_SMALL_CASES = [("loop wq+wk+wv", (256, 256, 256), 256), ("loop wo", (256,), 256),
                    ("loop gate+up", (64, 64), 256), ("loop down", (256,), 64)]
LOOP_CHUNK, LOOP_CACHE = 256, 1024 + 512
# Phase 11: mistralai/Mixtral-8x7B-v0.1's config.json as published, read by the port's
# config_from_hf_dict; depth cut to MIXTRAL_LAYERS of 32 (dense dispatch keeps the experts in bf16 in
# both formats: 2.82 GB a layer, so 32 layers would need about 93 GB). A synthetic pattern: 4 of
# the 8 KV heads of every layer are retrieval heads (sparsity 0.5).
MIXTRAL_HF_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05, "rope_theta": 1e6, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.36.0.dev0", "use_cache": True, "vocab_size": 32000,
}
MIXTRAL_LAYERS, MIXTRAL_FULL_HEADS = 8, 4
MIXTRAL_SERVE_LENS, MIXTRAL_SERVE_NEW = (6000, 1500, 3000), 24
# Phase 12 (tensor parallelism) at TP = 2 on the 8B geometry: a rank's KV heads of one group in a
# head-sharded layer (4 of them over 2 ranks), and the input depths of its row shards: wo (32 heads
# / 2 x 128) and w_down (14,336 / 2)
TP, TP_LOCAL_KV, TP_WO_K, TP_DOWN_K = 2, 2, 2048, 7168
# 12a: an 8,000-token prompt (two chunks) and 32 greedy tokens; 12c: three requests, one sampled.
# Both run the first TP_LAYERS layers of the 8B model and its pattern (3 of them head-sharded): at
# 32 layers their gloo all_reduces through the host took 191 s on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §4).
TP_PROMPT, TP_NEW, TP_SERVE_LENS, TP_SERVE_NEW, TP_LAYERS = 8000, 32, (6000, 1500, 3000), 24, 8
# 12d: Mixtral-8x7B's width cut to 2 layers, a 2,000-token prompt; a spawned sub-phase's time limit
TP_MOE_LAYERS, TP_MOE_PROMPT, TP_TIMEOUT_S = 2, 2000, 600

# Phase 13: PP stages on the one card (13a: phase 4's workload; 13b: the NIAH CLI with --pp at 32k, 3
# depths); 13c's (data 1, seq 2) training mesh: a 2,048-token step is SP13_LOCAL tokens a rank, the gates
# start at SP13_GATES (at 1.0 the student is the teacher and the distillation gradient is 0), the first
# SP13_LAYERS layers of constructed-8b: at all 32, 13c took 125-142 s (FSDP 25-38 s a step, a layer's
# gather through gloo) and the script 1,053 s of its 1,200 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# §4); 13d: the 1M-token cache over TP = 4 ranks.
PP, PP_NIAH_DEPTHS = 2, 3
SP13, SP13_STEPS, SP13_LAYERS, SP13_GATES = 2, 2, 8, 0.6
SP13_LOCAL = TRAIN_PAD // SP13
CTX_1M, TP_1M = 1 << 20, 4


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


def _decode_partition_record(case, cs, valid, Hkv, bucket):
    """The bf16 decode's grid and partition for a case, as the kernel works
    it out on the device (``flash.decode_partition``), logged and returned
    for its record."""
    import torch

    from duo_attention_tpu_torch.ops import flash

    row_keys = flash.decode_row_keys(cs, valid, bucket)
    nblocks = flash.decode_grid(len(cs), Hkv, bucket, torch.cuda.get_device_properties(0).multi_processor_count)
    tiles = [sum(-(-(hi - lo) // flash.DECODE_TILE_KEYS) for _, _, lo, hi in segs)
             for segs in flash.decode_partition(row_keys, Hkv, nblocks)]
    used = [t for t in tiles if t]
    log(f"  partition for {case}: bucket {bucket}, {len(cs) * Hkv} (b, KV head) pairs, {sum(row_keys)} keys a "
        f"head -> a grid of {nblocks}, {len(used)} with {min(used, default=0)}-{max(used, default=0)} tiles")
    require(not used or max(used) - min(used) <= 1, f"{case}: uneven shares {min(used)}-{max(used)}")
    return dict(blocks=nblocks, blocks_used=len(used), tiles_per_block=max(used, default=0))


def _pool_decode_cases(randn, record):
    """The bf16 decode at the serving pool's shape (longdoc): 16 rows, 5 live
    at 4k-28k keys and 11 freed at stale lengths with valid 0, bucket 32,768,
    hf 1, 4 and 8 with query groups of 4. The live rows against the plain
    version, the freed ones exactly 0."""
    import torch

    from duo_attention_tpu_torch.ops import flash

    dev = torch.device("cuda")
    B, T, D, live = 16, 32768, HEAD_DIM, 5
    rng = np.random.default_rng(17)
    valid = np.zeros(B, np.int32)
    valid[rng.choice(B, live, replace=False)] = 1
    cs = np.where(valid > 0, rng.integers(4096, 28672, B), rng.integers(0, 2 * T, B)).astype(np.int32)
    cs_arg, valid_arg = torch.tensor(cs, device=dev), torch.tensor(valid, device=dev)
    for hf in (1, 4, 8):
        case = f"decode pool B=16 hf={hf} ({live} live)"
        q = randn(B, 1, hf * GROUP, D, mul=Q_PEAK)
        k, v = randn(B, hf, T, D), randn(B, hf, T, D)
        extra = _decode_partition_record(case, cs.tolist(), valid.tolist(), hf, T)
        call = lambda: flash.full_cache_attention(q, k, v, cs_arg, bucket=T, valid=valid_arg)  # noqa: E731
        got = call()
        want = flash.full_cache_attention_plain(q, k, v, cs_arg, bucket=T, valid=valid_arg)
        on = torch.as_tensor(valid > 0, device=dev)
        err, ratio, ok = _attn_tol_ok(got[on], want[on])
        require(bool((got[~on] == 0).all()), f"{case}: a row with no query is not 0")
        keys = int((cs[valid > 0] + 1).sum())
        nbytes = 2 * (2 * B * hf * GROUP * D) + 2 * (2 * hf * D * keys)
        times = timed(call, lambda: flash.full_cache_attention_plain(q, k, v, cs_arg, bucket=T, valid=valid_arg))
        record("full_cache_attention.decode", case, err, ok, times, _bound(4 * D * hf * GROUP * keys, nbytes),
               ratio, **extra)
        del q, k, v


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
    from duo_attention_tpu_torch.engine import bucket_for_length
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
        bucket = bucket_for_length(int(csv.max()) + S, MAX_CACHE)
        q = randn(B, S, Hq, D, mul=Q_PEAK)
        kb, vb = k[:B, :Hkv].contiguous(), v[:B, :Hkv].contiguous()
        extra = {}
        if S == 1:
            extra = _decode_partition_record(case, csv.tolist(), None, Hkv, bucket)
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
            require(extra["blocks_used"] > B * Hkv, "the decode kernel did not spread the keys over the card")
    del k, v
    _pool_decode_cases(randn, record)
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
    """The small-M route at a path's decode shapes: bf16 x [M, K]
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


def _gemm_case(rec, gen, label, N, K, M, out_dtype, main=False):
    """The tiled route (prefill, training) from int8 x at one shape, bitwise
    against the plain version. Operations: 2*M*N*K int8 operations. Bytes: x,
    w, both scale vectors, the output. Library: torch._int_mm."""
    import torch

    from duo_attention_tpu_torch.ops import gemm

    dev = torch.device("cuda")
    xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
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
    rec.record("w8a8_matmul.tiled", f"{label} {N}x{K} M={M} {dt}", err, ok, times,
               _bound(2 * M * N * K, nbytes, PEAK_INT8_OPS), main=main, tops=2 * M * N * K / times[1] / 1e9,
               gbytes_per_s=nbytes / times[1] / 1e6)


def phase_kernels_w8a8kv4(rec):
    """Phase 3 for the three kernels of the W8A8KV4 format."""
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask
    from duo_attention_tpu_torch.engine import bucket_for_length
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
    def gemm_case(label, N, K, M, out_dtype, main=False):
        _gemm_case(rec, gen, label, N, K, M, out_dtype, main)

    for label, (N, K) in GEMM_SHAPES.items():
        # (the main path runs the head at M = B only; M = 4096 is here for the float32 tiled epilogue)
        gemm_case(label, N, K, CHUNK, torch.float32 if label == "head" else torch.bfloat16, main=label == "gate/up")
    for label in TRAIN_GEMM_LABELS:  # 10a's M: at N = 1024 one wave of tiles is not filled
        gemm_case(label, *GEMM_SHAPES[label], TRAIN_PAD, torch.bfloat16)
    for label, (N, K) in LOOP_GEMM_SHAPES.items():
        for M in LOOP_PREFILL_MS:
            gemm_case(label, N, K, M, torch.bfloat16)
    torch.cuda.empty_cache()
    for label, ns, K in SMALL_CASES:
        for M in (1, 4, 8, 16):
            _small_case(rec, gen, label, ns, K, M, main=(label, M) == ("gate+up", 1))
    for label, ns, K in LOOP_SMALL_CASES:
        _small_case(rec, gen, label, ns, K, 1)
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
        bucket = fixed_bucket[0] if fixed_bucket else bucket_for_length(int(csv.max()) + S, MAX_CACHE)
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


def phase_kernels_tp(rec):
    """Phase 3 at the shapes tensor parallelism (phase 12) gives the
    kernels: attention over TP_LOCAL_KV KV heads a rank (query group 4: the
    8B model's 8 KV heads over 2 ranks) in both formats, prefill and decode;
    the small-M product's int8-input mode with the x scale given (a row
    shard's cross-rank scale) at wo's and w_down's local depths, M = 1 and 8,
    and the tiled product at wo's, M = 4096, both with float32 output, as
    ops/quant.py::w8a8_linear_row_split runs them. Attention is held to its
    tolerance, the products bitwise; recorded as ``<kernel>`` cases named
    "tp ...". Library: SDPA on expanded K/V (INT4: dequantized first);
    torch._int_mm (x padded to 17 rows below M = 17)."""
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask, ring_mask, sink_mask
    from duo_attention_tpu_torch.ops import flash, gemm, quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    D, G, H = HEAD_DIM, GROUP, TP_LOCAL_KV
    Hq = H * G
    Ts, R = SINK + CHUNK, ((RECENT + CHUNK + 511) // 512) * 512

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * mul).to(torch.bfloat16)

    def attention_case(name, case, call, plain, mask, k_cat, v_cat, q, q4=False, kv_bytes=0):
        err, ratio, ok = _attn_tol_ok(call(), plain(), q4=q4)
        B, S = q.shape[:2]
        times = timed(call, plain, lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_cat, v_cat,
                                                                          attn_mask=mask))
        nbytes = 2 * (2 * B * S * Hq * D) + kv_bytes
        rec.record(name, f"tp {case} Hkv={H} Hq={Hq}", err, ok, times, _bound(4 * D * Hq * int(mask.sum()), nbytes),
                   ratio)

    k, v = randn(1, H, MAX_CACHE, D), randn(1, H, MAX_CACHE, D)
    kq, ks = quant.quantize_int4_paired(k)
    vq, vs = quant.quantize_int4_paired(v)
    for S, cs in ((CHUNK, 12288), (1, 16000)):
        kind = "decode" if S == 1 else "prefill"
        q = randn(1, S, Hq, D, mul=Q_PEAK)
        cs_arg = torch.tensor(cs, dtype=torch.int32, device=dev)
        bucket = min(1 << (cs + S - 1).bit_length(), MAX_CACHE)
        mask = full_mask(cs + torch.arange(S, device=dev), bucket)[None, None]
        kc, vc = k[:, :, :bucket].repeat_interleave(G, dim=1), v[:, :, :bucket].repeat_interleave(G, dim=1)
        attention_case(f"full_cache_attention.{kind}", f"{kind} cs={cs}",
                       lambda: flash.full_cache_attention(q, k, v, cs_arg, bucket=bucket),
                       lambda: flash.full_cache_attention_plain(q, k, v, cs_arg, bucket=bucket),
                       mask, kc, vc, q, kv_bytes=2 * 2 * H * D * (cs + S))
        rows = bucket // 2
        kd = quant.dequantize_int4_paired(kq[:, :, :rows], ks[..., :rows]).bfloat16().repeat_interleave(G, dim=1)
        vd = quant.dequantize_int4_paired(vq[:, :, :rows], vs[..., :rows]).bfloat16().repeat_interleave(G, dim=1)
        attention_case(f"full_cache_attention_q4.{kind}", f"{kind} cs={cs}",
                       lambda: flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs_arg, bucket=bucket),
                       lambda: flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, cs_arg, bucket=bucket),
                       mask, kd, vd, q, q4=True, kv_bytes=2 * H * (cs + S) * (D // 2 + 4))
        del kc, vc, kd, vd
        sk, sv, rk, rv = randn(1, H, Ts, D), randn(1, H, Ts, D), randn(1, H, R, D), randn(1, H, R, D)
        qpos = cs + torch.arange(S, device=dev)
        smask = torch.cat([sink_mask(qpos, SINK, SINK), ring_mask(qpos, R, cs + S, cs, SINK, RECENT)], dim=-1)[None, None]
        kc = torch.cat([sk[:, :, :SINK], rk], dim=2).repeat_interleave(G, dim=1)
        vc = torch.cat([sv[:, :, :SINK], rv], dim=2).repeat_interleave(G, dim=1)
        tot = cs_arg + S
        attention_case(f"streaming_cache_attention.{kind}", f"{kind} cs={cs}",
                       lambda: flash.streaming_cache_attention(q, sk, sv, rk, rv, cs_arg, tot, SINK, RECENT),
                       lambda: flash.streaming_cache_attention_plain(q, sk, sv, rk, rv, cs_arg, tot, SINK, RECENT),
                       smask, kc, vc, q, kv_bytes=2 * 2 * H * D * int(smask.any(dim=2).sum()))
        del kc, vc, sk, sv, rk, rv
    del k, v, kq, ks, vq, vs

    # the row shards' products: x quantized with the whole row's scale (given), float32 out
    E = GEMM_SHAPES["wq/wo"][0]
    for label, K, Ms, route in (("wo", TP_WO_K, (1, 8), "small"), ("w_down", TP_DOWN_K, (1, 8), "small"),
                                ("wo", TP_WO_K, (CHUNK,), "tiled")):
        wq = torch.randint(-127, 128, (E, K), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((E,), generator=gen, device=dev) * 1e-3 + 1e-4
        for M in Ms:
            x = randn(M, K, mul=2.0)
            # a scale from a wider row (the other rank's half), as the all_reduce MAX gives it
            xf = x.float()
            xq, xs = quant._quantize_rows(xf, xf.abs().amax(-1, keepdim=True) * 1.5)
            got = gemm.w8a8_matmul(xq, xs, wq, ws, torch.float32, route=route)
            want = gemm.w8a8_matmul_plain(xq, xs, wq, ws, torch.float32)
            ok = torch.equal(got, want)
            err = float((got - want).abs().max())
            pad = max(17 - M, 0)
            xp = torch.cat([xq, xq.new_zeros(pad, K)])
            wt = wq.t()
            library = lambda: (torch._int_mm(xp, wt)[:M].float() * xs) * ws  # noqa: E731
            require(torch.equal(library(), want), f"torch._int_mm disagrees with the plain version ({label} M={M})")
            times = timed(lambda: gemm.w8a8_matmul(xq, xs, wq, ws, torch.float32, route=route),
                          lambda: gemm.w8a8_matmul_plain(xq, xs, wq, ws, torch.float32), library)
            nbytes = M * K + E * K + 4 * (M + E) + 4 * M * E
            rec.record(f"w8a8_matmul.{route}", f"tp {label} row shard {E}x{K} M={M} int8 x f32", err, ok, times,
                       _bound(2 * M * E * K, nbytes, PEAK_INT8_OPS))
        del wq
    torch.cuda.empty_cache()


def phase_kernels_d64(rec):
    """Phase 3 at head_dim 64: every attention kernel's D = 64 instantiation
    (prefill and decode of the bf16 full heads, the streaming heads and the
    INT4 full heads) and the three writes, against their plain versions with
    the tolerances of D = 128. The main cases are 10b's shapes (the
    constructed circuit: 4 KV heads of 64, 2 full and 2 streaming at
    sparsity 0.5, one query head each, chunks of LOOP_CHUNK, a cache of
    LOOP_CACHE, sink 16, recent 64); the others are the 8B path's shapes
    with D = 64, beside phase 3's D = 128 times. Recorded under
    ``<kernel>.d64``."""
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask, ring_mask, sink_mask
    from duo_attention_tpu_torch.engine import bucket_for_length
    from duo_attention_tpu_torch.ops import flash, inplace, quant
    from duo_attention_tpu_torch.utils import cuda_time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6464)
    D = 64
    record = rec.record

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * mul).to(torch.bfloat16)

    def vec(x, B):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1).expand(B).long()

    # (case, B, S, cs, KV heads, query heads per KV head, cache slots, chunk, sink, recent, main)
    loop = (2, 1, LOOP_CACHE, LOOP_CHUNK, 16, 64)
    big = (4, GROUP, MAX_CACHE, CHUNK, SINK, RECENT)
    cases = [("prefill 10b S=256 cs=768", 1, LOOP_CHUNK, 768, *loop, True),
             ("decode 10b cs=1000", 1, 1, 1000, *loop, True),
             ("prefill 8B shape cs=12288", 1, CHUNK, 12288, *big, False),
             ("decode 8B shape cs=16000", 1, 1, 16000, *big, False),
             ("decode 8B shape cs=[B] B=4", 4, 1, [5, 4096, 12345, 32000], *big, False)]
    for case, B, S, cs, Hkv, G, T, chunk, sink, recent, main in cases:
        kind = "decode" if S == 1 else "prefill"
        Hq = Hkv * G
        csv = vec(cs, B)
        cs_arg = torch.as_tensor(cs, dtype=torch.int32, device=dev)
        q = randn(B, S, Hq, D, mul=Q_PEAK)
        bucket = bucket_for_length(int(csv.max()) + S, T)
        qpos = csv[:, None] + torch.arange(S, device=dev)
        mask = full_mask(qpos, bucket)[:, None]  # [B, 1, S, bucket]
        flops = 4 * D * Hq * int(mask.sum())
        tokens = int((csv + S).sum())
        qt = q.transpose(1, 2)

        # bf16 full heads
        k, v = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        call = lambda: flash.full_cache_attention(q, k, v, cs_arg, bucket=bucket)  # noqa: E731
        plain = lambda: flash.full_cache_attention_plain(q, k, v, cs_arg, bucket=bucket)  # noqa: E731
        err, ratio, ok = _attn_tol_ok(call(), plain())
        kc, vc = (t[:, :, :bucket].repeat_interleave(G, dim=1) for t in (k, v))
        times = timed(call, plain, lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask))
        nbytes = 2 * (2 * B * S * Hq * D) + 2 * (2 * Hkv * D * tokens)
        record(f"full_cache_attention.{kind}.d64", case, err, ok, times, _bound(flops, nbytes), ratio, main=main)
        del k, v, kc, vc

        # INT4 full heads; the yardstick is SDPA over a bf16 copy dequantized beforehand
        kq, ks = quant.quantize_int4_paired(randn(B, Hkv, T, D))
        vq, vs = quant.quantize_int4_paired(randn(B, Hkv, T, D))
        bufs = [t.contiguous() for t in (kq, ks, vq, vs)]
        call = lambda: flash.full_cache_attention_q4(q, *bufs, cs_arg, bucket=bucket)  # noqa: E731
        plain = lambda: flash.full_cache_attention_q4_plain(q, *bufs, cs_arg, bucket=bucket)  # noqa: E731
        err, ratio, ok = _attn_tol_ok(call(), plain(), q4=True)
        rows = bucket // 2
        dequant = lambda: (quant.dequantize_int4_paired(bufs[0][:, :, :rows], bufs[1][..., :rows]).bfloat16(),  # noqa: E731
                           quant.dequantize_int4_paired(bufs[2][:, :, :rows], bufs[3][..., :rows]).bfloat16())
        dequant_ms = cuda_time_ms(dequant, iters=3, warmup=1)
        kc, vc = (t.repeat_interleave(G, dim=1) for t in dequant())
        times = timed(call, plain, lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask))
        nbytes = 2 * (2 * B * S * Hq * D) + 2 * Hkv * tokens * (D // 2 + 4)
        record(f"full_cache_attention_q4.{kind}.d64", case, err, ok, times, _bound(flops, nbytes), ratio,
               main=main, library_dequant_ms=dequant_ms)
        del bufs, kq, ks, vq, vs, kc, vc, mask

        # streaming heads over the sink buffer and the ring
        Ts, R = sink + chunk, -(-(recent + chunk) // 512) * 512
        sbufs = [randn(B, Hkv, Ts, D), randn(B, Hkv, Ts, D), randn(B, Hkv, R, D), randn(B, Hkv, R, D)]
        tot_arg = cs_arg + S
        call = lambda: flash.streaming_cache_attention(q, *sbufs, cs_arg, tot_arg, sink, recent)  # noqa: E731
        plain = lambda: flash.streaming_cache_attention_plain(q, *sbufs, cs_arg, tot_arg, sink, recent)  # noqa: E731
        err, ratio, ok = _attn_tol_ok(call(), plain())
        smask = torch.stack([torch.cat([sink_mask(qpos[b], sink, sink),
                                        ring_mask(qpos[b], R, csv[b] + S, csv[b], sink, recent)], dim=-1)
                             for b in range(B)])[:, None]  # [B, 1, S, sink + R]
        kc = torch.cat([sbufs[0][:, :, :sink], sbufs[2]], dim=2).repeat_interleave(G, dim=1)
        vc = torch.cat([sbufs[1][:, :, :sink], sbufs[3]], dim=2).repeat_interleave(G, dim=1)
        times = timed(call, plain, lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=smask))
        slots = int(smask.any(dim=2).sum())
        nbytes = 2 * (2 * B * S * Hq * D) + 2 * (2 * Hkv * D * slots)
        record(f"streaming_cache_attention.{kind}.d64", case, err, ok, times,
               _bound(4 * D * Hq * int(smask.sum()), nbytes), ratio, main=main)
        del sbufs, kc, vc, smask

        if S != 1:
            continue
        # the decode step's writes: a layer's K and V rows read in place from [B, 1, 2 Hkv, D] projections
        # (the first Hkv heads full, the rest streaming), one launch each, bitwise the plain versions
        krow_full, vrow_full = (randn(B, 1, 2 * Hkv, D)[:, :, :Hkv].transpose(1, 2) for _ in range(2))
        krow_str, vrow_str = (randn(B, 1, 2 * Hkv, D)[:, :, Hkv:].transpose(1, 2) for _ in range(2))
        kbuf, vbuf = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        refs = kbuf.clone(), vbuf.clone()
        inplace.write_row(kbuf, krow_full, cs_arg, vbuf, vrow_full)
        inplace.write_row_plain(refs[0], krow_full, cs_arg, refs[1], vrow_full)
        ok = torch.equal(kbuf, refs[0]) and torch.equal(vbuf, refs[1])
        p = csv.clamp(0, T - 1)
        bi = torch.arange(B, device=dev)

        def put_rows(buf, slot, row):  # the library's form: an indexed assignment a buffer
            buf[bi, :, slot] = row[:, :, 0]

        times = timed(lambda: inplace.write_row(kbuf, krow_full, cs_arg, vbuf, vrow_full),
                      lambda: inplace.write_row_plain(refs[0], krow_full, cs_arg, refs[1], vrow_full),
                      lambda: (put_rows(kbuf, p, krow_full), put_rows(vbuf, p, vrow_full)))
        record("write_row.d64", case, 0.0 if ok else float("inf"), ok, times, _bound(0, 2 * 2 * (2 * B * Hkv * D)),
               main=main)
        del kbuf, vbuf, refs

        sbufs = [randn(B, Hkv, Ts, D), randn(B, Hkv, Ts, D), randn(B, Hkv, R, D), randn(B, Hkv, R, D)]
        srefs = [t.clone() for t in sbufs]
        inplace.write_streaming_rows(*sbufs, krow_str, vrow_str, cs_arg, sink)
        inplace.write_streaming_rows_plain(*srefs, krow_str, vrow_str, cs_arg, sink)
        ok = all(torch.equal(a, b) for a, b in zip(sbufs, srefs))
        sink_slot, ring_slot = csv.clamp(max=sink), csv % R
        times = timed(lambda: inplace.write_streaming_rows(*sbufs, krow_str, vrow_str, cs_arg, sink),
                      lambda: inplace.write_streaming_rows_plain(*srefs, krow_str, vrow_str, cs_arg, sink),
                      lambda: [put_rows(b_, s_, r_) for b_, r_, s_ in ((sbufs[0], krow_str, sink_slot),
                                                                       (sbufs[1], vrow_str, sink_slot),
                                                                       (sbufs[2], krow_str, ring_slot),
                                                                       (sbufs[3], vrow_str, ring_slot))])
        record("write_streaming_rows.d64", case, 0.0 if ok else float("inf"), ok, times,
               _bound(0, 2 * (2 * B * Hkv * D) + 4 * (2 * B * Hkv * D)), main=main)
        del sbufs, srefs

        T2 = T // 2
        qbufs = [torch.randint(0, 256, (B, Hkv, T2, D), generator=gen, device=dev, dtype=torch.uint8),
                 randn(B, Hkv, 4, T2), torch.randint(0, 256, (B, Hkv, T2, D), generator=gen, device=dev,
                                                     dtype=torch.uint8), randn(B, Hkv, 4, T2)]
        qrefs = [t.clone() for t in qbufs]
        inplace.write_q4_token(qbufs[0], qbufs[1], krow_full, cs_arg, qbufs[2], qbufs[3], vrow_full)
        inplace.write_q4_token_plain(qrefs[0], qrefs[1], krow_full, cs_arg, qrefs[2], qrefs[3], vrow_full)
        ok = (torch.equal(qbufs[0], qrefs[0]) and torch.equal(qbufs[2], qrefs[2])
              and torch.equal(qbufs[1].view(torch.int16), qrefs[1].view(torch.int16))
              and torch.equal(qbufs[3].view(torch.int16), qrefs[3].view(torch.int16)))
        times = timed(lambda: inplace.write_q4_token(qbufs[0], qbufs[1], krow_full, cs_arg, qbufs[2], qbufs[3],
                                                     vrow_full),
                      lambda: inplace.write_q4_token_plain(qrefs[0], qrefs[1], krow_full, cs_arg, qrefs[2],
                                                           qrefs[3], vrow_full))
        record("write_q4_token.d64", case, 0.0 if ok else float("inf"), ok, times,
               _bound(0, 2 * B * Hkv * (2 * D + 2 * D + 4)), main=main)
        del qbufs, qrefs
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

    return {name: c for name, c in launches.counters().items()
            if c[1] != "cuda_calls" and not name.startswith(launches.COLLECTIVE)}


def _collective_counters():
    """The collectives' counters (parallel/mesh.py), by name without the prefix."""
    from duo_attention_tpu_torch.ops import launches

    return {name.removeprefix(launches.COLLECTIVE): c for name, c in launches.counters().items()
            if name.startswith(launches.COLLECTIVE)}


def _plain_functions():
    from duo_attention_tpu_torch.ops import launches

    return [fn for fn, attr in launches.counters().values() if attr == "cuda_calls"]


def reset_counts():
    for fn, attr in (*_counters().values(), *_collective_counters().values()):
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


def _expected_launches(cfg, duo, q4, n_chunks, steps):
    """Each kernel's launches in a prefill of ``n_chunks`` chunks and
    ``steps`` decode steps of the main path, from the pattern's per-layer
    split (and no plain version run on the card)."""
    hf_layers = sum(1 for n in duo.num_full_kv_heads if n > 0)
    hs_layers = sum(1 for n in duo.num_full_kv_heads if n < cfg.num_kv_heads)
    full = "full_cache_attention_q4" if q4 else "full_cache_attention"
    expected = dict.fromkeys(_counters(), 0)
    expected.update({
        full + ".prefill": n_chunks * hf_layers,
        full + ".decode": steps * hf_layers,
        "streaming_cache_attention.prefill": n_chunks * hs_layers,
        "streaming_cache_attention.decode": steps * hs_layers,
        # K and V rows in one launch (INT4: each quantized on the way)
        "write_q4_token" if q4 else "write_row": steps * hf_layers,
        "write_streaming_rows": steps * hs_layers,
        "plain_cuda_calls": 0,
    })
    if q4:  # 7 projections a layer (a MoE layer: the 4 of attention; its experts stay bf16) and the head
        moe = cfg.num_local_experts > 0
        expected["w8a8_matmul.tiled"] = n_chunks * (4 if moe else 7) * cfg.num_layers  # M = 4096, a launch a weight
        # M = 1: one launch for wq+wk+wv, wo (and gate+up, down), and the head: 129 a step for the 8B model
        expected["w8a8_matmul.small"] = n_chunks + steps * ((2 if moe else 4) * cfg.num_layers + 1)
    return expected


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
    expected = _expected_launches(cfg, duo, q4, n_chunks, NEW_TOKENS)
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
    """The port's kernels by name (prefill_kernel<0, D> is full heads, <1, D>
    streaming; the bf16 full-head decode is a split kernel and its merge),
    cuBLAS matrix products, and everything else."""
    ours = {"prefill_kernel<0,": "full_cache_attention.prefill",  # <MODE, D>
            "prefill_kernel<1,": "streaming_cache_attention.prefill",
            "stream_decode_kernel": "streaming_cache_attention.decode",  # before decode_kernel<, a part of its name
            "decode_kernel<": "full_cache_attention.decode",
            "decode_merge_kernel": "full_cache_attention.decode",
            "write_streaming_rows_kernel": "write_streaming_rows", "write_row_kernel": "write_row",
            "prefill_q4_kernel": "full_cache_attention_q4.prefill",
            "decode_q4_kernel": "full_cache_attention_q4.decode",
            "write_q4_token_kernel": "write_q4_token",
            "w8a8_tiled_kernel": "w8a8_matmul.tiled", "w8a8_small_mma_kernel": "w8a8_matmul.small",
            "w8a8_quantize_rows_kernel": "w8a8_matmul.quantize"}
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


class _PinnedRouting:
    """While active, models/llama.py's MoE router records the experts each
    call picks (``replay`` False) or hands each call the experts the same
    call of the recorded run picked, weighted by the softmax of this run's
    own logits over them (``replay`` True). Top-k routing is a step function:
    a last-bit difference between two runs can pick another expert where two
    router logits tie, and that token's MLP output then differs by the whole
    expert; pinned, two runs differ only by their arithmetic."""

    def __init__(self):
        self.chosen, self.replay, self.calls = [], False, 0

    def __enter__(self):
        import torch

        from duo_attention_tpu_torch.models import llama

        self.llama, self.kept = llama, llama.moe_router

        def router(layer, x, top_k):
            if not self.replay:
                combine = self.kept(layer, x, top_k)
                self.chosen.append(torch.topk(combine, top_k, dim=-1).indices)  # the nonzero weights
                return combine
            topi = self.chosen[self.calls]
            self.calls += 1
            logits = x.float() @ layer["moe_gate"].float()
            return torch.zeros_like(logits).scatter_(-1, topi, torch.softmax(logits.gather(-1, topi), dim=-1))

        llama.moe_router = router
        return self

    def __exit__(self, *exc):
        self.llama.moe_router = self.kept


def phase_kernel_vs_plain(params, cfg, duo, kv_quant="none", layers=4, prompt=6000, steps=8):
    import torch

    from duo_attention_tpu_torch.cache import cache_constructor
    from duo_attention_tpu_torch.engine import bucket_for_length
    from duo_attention_tpu_torch.models import llama

    cfg4 = dataclasses.replace(cfg, num_layers=layers)
    duo4 = dataclasses.replace(duo, num_full_kv_heads=duo.num_full_kv_heads[:layers])
    params4 = dict(params, layers=params["layers"][:layers])
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt))
    dev = torch.device("cuda")
    new_cache = cache_constructor(kv_quant)

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
                    full_bucket=bucket_for_length(off + CHUNK, MAX_CACHE), plain=plain)
            out = [llama.logits_at(params4, hidden, n - 1, plain=plain)]
            fed = []
            bucket = bucket_for_length(prompt + steps, MAX_CACHE)
            for i in range(steps):
                t = int(torch.argmax(out[-1])) if feed is None else feed[i]
                fed.append(t)
                hidden, cache = llama.forward_chunk(
                    params4, cfg4, duo4, cache, torch.tensor([[t]], device=dev), 1,
                    full_bucket=bucket, plain=plain)
                out.append(llama.logits_at(params4, hidden, 0, plain=plain))
        return torch.cat(out), fed

    # the kernel path decodes greedily; the plain path is fed the same tokens (and, in a MoE model,
    # its router the same experts; _PinnedRouting)
    with _PinnedRouting() as pinned:
        kern, feed = run(False)
        pinned.replay = True
        plain, _ = run(True, feed)
        require(pinned.calls == len(pinned.chosen), f"router calls {pinned.calls} of {len(pinned.chosen)}")
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
    (teacher-forced). Returns ([len(stream)] floats, and for a MoE model
    [len(stream)] router gaps: the smallest gap between the k-th and the
    (k+1)-th expert logit over the layers of the step that made that token's
    logits; inf for the first, from the prefill, which serving repeats
    exactly)."""
    import torch

    from duo_attention_tpu_torch.models import llama

    cache, logits = engine.prefill(prompt[None])
    bucket = engine.bucket_for(len(prompt) + len(stream))
    gaps, router_gaps, step = [], [float("inf")], []
    kept = llama.moe_router

    def router(layer, x, top_k):
        top = torch.topk(x.float() @ layer["moe_gate"].float(), top_k + 1, dim=-1).values
        step.append(float((top[..., top_k - 1] - top[..., top_k]).min()))
        return kept(layer, x, top_k)

    llama.moe_router = router
    try:
        with torch.no_grad():
            for t in range(len(stream)):
                top = logits.float().topk(2, dim=-1).values[0]
                gaps.append(float(top[0] - top[1]))
                if t + 1 < len(stream):
                    step.clear()
                    tok = torch.tensor([[stream[t]]], device="cuda")
                    hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tok, 1, full_bucket=bucket)
                    logits = llama.logits_at(params, hidden, 0)
                    router_gaps.append(min(step, default=float("inf")))
    finally:
        llama.moe_router = kept
    return gaps, router_gaps


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
    isolated run (in a MoE model, or up to its first router near-tie: a gap
    below ROUTER_NEAR_TIE between the k-th and (k+1)-th expert logits in any
    layer), and that 8 replays of the pool step launch 8 times the
    counters' kernels."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, kv_memory_bytes
    from duo_attention_tpu_torch.evals import serving_bench

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    greedy = [i for i in range(len(lens)) if sampling.get(i) is None or sampling[i].is_greedy]
    single = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant, decode_burst=SERVE_BURST)
    iso, gaps, router_gaps = {}, {}, {}
    t0 = time.perf_counter()
    for i in greedy:
        iso[i] = single.generate(prompts[i][None], max_new)[0][0].tolist()
        gaps[i], router_gaps[i] = _top2_margins(single, params, cfg, duo, prompts[i], iso[i])
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
        # a MoE model's router near-tie: from that step on another expert may have been picked
        rtie = next((t for t, g in enumerate(router_gaps[i]) if g < ROUTER_NEAR_TIE), len(gaps[i]))
        prefix = next((t for t, (a, b) in enumerate(zip(served[i], iso[i])) if a != b), min(len(served[i]), len(iso[i])))
        diverged = prefix < len(served[i])
        agreement[i] = dict(agreeing_prefix=prefix, first_near_tie=tie, served=len(served[i]),
                            gap_at_first_near_tie=gaps[i][tie] if tie < len(gaps[i]) else None,
                            gap_at_divergence=gaps[i][prefix] if diverged else None,
                            first_router_near_tie=rtie, smallest_router_gap=min(router_gaps[i]))
        log(f"  request {i} (prompt {lens[i]}): served {len(served[i])} tokens, agrees with its isolated run for "
            f"{prefix}" + (f" (isolated top-2 gap there {gaps[i][prefix]:.4f})" if diverged else "")
            + f"; its first near-tie (top-2 gap < {NEAR_TIE}) at {tie}"
            + (f" (gap {gaps[i][tie]:.4f})" if tie < len(gaps[i]) else " (none)")
            + (f"; first router near-tie (gap < {ROUTER_NEAR_TIE}) at {rtie}, smallest router gap "
               f"{min(router_gaps[i]):.4f}" if cfg.num_local_experts else ""))
        require(served[i][0] == iso[i][0], f"request {i}: first token {served[i][0]}, isolated {iso[i][0]}")
        require(prefix >= min(tie, rtie, len(served[i])),
                f"request {i} diverged at {prefix} before its first near-tie {min(tie, rtie)}")
        # the same context up to the divergence: the served step flipped a token only where the
        # isolated run had a near-tie (or after a router near-tie)
        require(not diverged or agreement[i]["gap_at_divergence"] < NEAR_TIE or rtie <= prefix,
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
# Phase 9: the eval stack at full width (the constructed circuit in the 8B geometry)
# ---------------------------------------------------------------------------


class _EngineClock:
    """Times a DuoEngine's prefill calls (each through a synchronize), as
    generate and the NIAH harness make them, and keeps the cache its last
    decode_tokens call returned."""

    def __init__(self, engine):
        import torch

        self.prefill_s, self.cache = [], None
        prefill, decode = engine.prefill, engine.decode_tokens

        def timed_prefill(*a, **k):
            t0 = time.perf_counter()
            out = prefill(*a, **k)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            return out

        def kept_decode(*a, **k):
            tokens, self.cache = decode(*a, **k)
            return tokens, self.cache

        engine.prefill, engine.decode_tokens = timed_prefill, kept_decode


def _steady_decode(engine, clock, steps=EVAL_STEADY_STEPS):
    """(ms/token of ``steps`` more greedy tokens on the cache of the clock's
    last decode, its captured step replayed once a token; the prompt tokens
    that cache held). Frees the cache."""
    import torch

    length = int(clock.cache.length)
    token = torch.zeros((1,), dtype=torch.long, device="cuda")
    t0 = time.perf_counter()
    tokens, _ = engine.decode_tokens(clock.cache, token, steps, length=length)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    require(((tokens >= 0) & (tokens < engine.cfg.vocab_size)).all(), "steady decode overran the cache")
    clock.cache = None
    return ms, length - EVAL_GEN


def _niah_engine(params, cfg, nf, sink, recent, max_cache):
    import torch

    from duo_attention_tpu_torch import DuoConfig, DuoEngine

    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=nf, max_cache_size=max_cache,
                    prefill_chunk_size=CHUNK)
    engine = DuoEngine(params, cfg, duo, dtype=torch.bfloat16, device="cuda", kv_quant="int4", single_bucket=True)
    return engine, _EngineClock(engine)


def _fresh_dir(*parts, phase="phase9"):
    import shutil

    path = os.path.join(REPO, "chiprun_out", phase, *parts)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def phase_eval_niah(base, cfg, needle, heads, sink, recent):
    """9a: the NIAH grid through NIAHTester on the constructed 8B graft in
    W8A8KV4: 32k at EVAL_DEPTHS depths with the trained pattern and with
    the inverted one, one 131k cell and one simulation-mode 32k cell
    (trained). Also one 32k cell on an engine whose single bucket is just
    above 32k: the prefill and decode cost of the dead keys past the live
    length in the 131k bucket."""
    import torch

    from duo_attention_tpu_torch import kv_memory_bytes
    from duo_attention_tpu_torch.evals.niah import NIAHConfig, NIAHTester
    from duo_attention_tpu_torch.models.convert import reorder_params
    from duo_attention_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer("word")
    depths = list(np.linspace(0, 100, EVAL_DEPTHS))
    out = dict(cells={})

    def tester(engine, name, sim=0):
        return NIAHTester(engine, tok, NIAHConfig(
            context_lengths=[EVAL_CTX], depth_percents=depths, gen_tokens=EVAL_GEN, simulation_tokens=sim,
            output_dir=_fresh_dir("niah", name), resume=False, **needle))

    reset_counts()
    for name, pattern in (("trained", heads), ("inverted", 1.0 - heads)):
        params, nf = reorder_params(base, cfg, pattern)
        engine, clock = _niah_engine(params, cfg, nf, sink, recent, NIAH_MAX_CACHE)
        t0 = time.perf_counter()
        cells = tester(engine, name).run()
        for c, ttft in zip(cells, clock.prefill_s):
            c["ttft_s"] = ttft
            log(f"  {name} ctx {c['context_length']} depth {c['depth_percent']:5.1f}%: overlap "
                f"{c['word_overlap']:.2f} score {c['score']:.2f} response {c['response']!r} latency "
                f"{c['latency_s']:.3f} s (prefill {ttft:.3f} s)")
        out["cells"][name] = cells
        out[name + "_grid_s"] = time.perf_counter() - t0
        if name == "trained":
            # the cache of the last cell (32k): steady decode at 32k in the 131k bucket
            ms, tokens = _steady_decode(engine, clock)
            live = dict(ttft_s=float(np.median(clock.prefill_s)), decode_ms=ms, prompt_tokens=tokens)
            clock.prefill_s.clear()
            t0 = time.perf_counter()
            long_cell = tester(engine, "long").run_cell(NIAH_LONG_CTX, 50.0)
            long_cell.update(ttft_s=clock.prefill_s[-1], kv_bytes=kv_memory_bytes(clock.cache))
            long_cell["decode_ms"], long_cell["prompt_tokens"] = _steady_decode(engine, clock)
            out["long_cell"], out["long_s"] = long_cell, time.perf_counter() - t0
            log(f"  trained ctx {NIAH_LONG_CTX} ({long_cell['prompt_tokens']} prompt tokens) depth 50%: overlap "
                f"{long_cell['word_overlap']:.2f} response "
                f"{long_cell['response']!r}; TTFT {long_cell['ttft_s']:.3f} s, steady decode "
                f"{long_cell['decode_ms']:.3f} ms/token, KV {long_cell['kv_bytes'] / 2**30:.3f} GiB, latency "
                f"{long_cell['latency_s']:.3f} s")
            sim_cell = tester(engine, "simulation", sim=EVAL_SIM).run_cell(EVAL_CTX, 50.0)
            out["simulation_cell"] = sim_cell
            log(f"  trained ctx {EVAL_CTX} depth 50%, simulation mode ({EVAL_SIM} tokens): overlap "
                f"{sim_cell['word_overlap']:.2f} response {sim_cell['response']!r}")
            # the same 32k cell on an engine whose single bucket is the smallest above 32k
            del engine, clock
            small, sclock = _niah_engine(params, cfg, nf, sink, recent, NIAH_SMALL_CACHE)
            cell = tester(small, "small_bucket").run_cell(EVAL_CTX, 50.0)
            ms, tokens = _steady_decode(small, sclock)
            tight = dict(ttft_s=sclock.prefill_s[-1], decode_ms=ms, prompt_tokens=tokens,
                         word_overlap=cell["word_overlap"], response=cell["response"])
            out["bucket_cost"] = {str(NIAH_MAX_CACHE): live, str(NIAH_SMALL_CACHE): tight}
            log(f"  {tokens}-token prompt, single bucket {NIAH_MAX_CACHE}: TTFT {live['ttft_s']:.3f} s (median of the grid), "
                f"decode {live['decode_ms']:.3f} ms/token; bucket {NIAH_SMALL_CACHE}: TTFT {tight['ttft_s']:.3f} s, "
                f"decode {tight['decode_ms']:.3f} ms/token, overlap {cell['word_overlap']:.2f}")
            del small, sclock
        else:
            del engine, clock
        del params
        torch.cuda.empty_cache()
    counts = read_counts()
    out["counts"] = counts
    log("  grid (word overlap), ctx " + str(EVAL_CTX) + ":\n" + "\n".join(
        f"    depth {d:5.1f}%  trained {t['word_overlap']:.2f}  inverted {i['word_overlap']:.2f}"
        for d, t, i in zip(depths, out["cells"]["trained"], out["cells"]["inverted"])))
    log(f"  launches during 9a: {counts}")
    require(counts["plain_cuda_calls"] == 0, f"9a called plain versions on the card: {counts}")
    for name in EVAL_KERNELS:
        require(counts[name] > 0, f"9a launched no {name}")
    trained = out["cells"]["trained"] + [out["long_cell"], out["simulation_cell"],
                                         dict(word_overlap=out["bucket_cost"][str(NIAH_SMALL_CACHE)]["word_overlap"])]
    require(all(c["word_overlap"] == 1.0 for c in trained),
            f"a trained cell missed the needle: {[c['word_overlap'] for c in trained]}")
    interior = [c["word_overlap"] for c in out["cells"]["inverted"][1:-1]]
    out["inverted_interior_mean"] = float(np.mean(interior))
    require(out["inverted_interior_mean"] <= 0.25,
            f"the inverted pattern still retrieves at interior depths: mean overlap {out['inverted_interior_mean']}")
    return out


def phase_eval_longbench(base, cfg, heads, sink, recent):
    """9b: trec and lsht through longbench.predict_task and score_file with
    scripts/run_longbench_tpu.sh's settings, trained and inverted."""
    import torch

    from duo_attention_tpu_torch import DuoConfig, DuoEngine
    from duo_attention_tpu_torch.evals import longbench
    from duo_attention_tpu_torch.models.convert import reorder_params
    from duo_attention_tpu_torch.tokenizer import encode_ids, get_tokenizer

    tok = get_tokenizer("word")
    stop = tuple(encode_ids(tok, ".")[-1:])
    data_dir = os.path.join(REPO, "artifacts", "longbench_tpu", "data")
    scores = {}
    reset_counts()
    for name, pattern in (("trained", heads), ("inverted", 1.0 - heads)):
        params, nf = reorder_params(base, cfg, pattern)
        duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=nf, max_cache_size=LB_MAX_CACHE,
                        prefill_chunk_size=LB_CHUNK)
        engine = DuoEngine(params, cfg, duo, dtype=torch.bfloat16, device="cuda", kv_quant="int4",
                           single_bucket=True)
        out_dir = _fresh_dir("longbench", name)
        for task in LB_TASKS:
            path = os.path.join(out_dir, f"{task}.jsonl")
            longbench.predict_task(engine, tok, task, longbench.load_task_data(task, data_dir), LB_PROMPT, path,
                                   simulation_tokens=LB_SIM, stop_ids=stop)
            scores[f"{name}/{task}"] = longbench.score_file(task, path)
            preds = [json.loads(line)["pred"] for line in open(path)]
            log(f"  {name} {task}: {scores[name + '/' + task]} ({len(preds)} records; predictions {preds})")
        del engine, params
        torch.cuda.empty_cache()
    counts = read_counts()
    log(f"  launches during 9b: {counts}")
    require(counts["plain_cuda_calls"] == 0, f"9b called plain versions on the card: {counts}")
    for task in LB_TASKS:
        require(scores[f"trained/{task}"] >= 87.5, f"trained {task} scored {scores['trained/' + task]}")
        require(scores[f"inverted/{task}"] <= 25.0, f"inverted {task} scored {scores['inverted/' + task]}")
    return dict(scores=scores, counts=counts)


def _kv_bytes_reckoned(cfg, duo, batch, decode_only=False, heads=None, q4=True):
    """The cache's bytes from its shapes: an INT4 full head holds a byte a
    channel per token pair and four bf16 scale rows per pair (scale and zero
    point of both tokens), a bf16 one two bytes a channel per token, K and V;
    a streaming head its bf16 sink rows and ring rows (chunked prefill:
    sink + chunk and round_up(recent + chunk, 512); decode-only:
    round_up(sink + 8, 8) and round_up(recent + 8, 128)). ``heads``: per-layer
    (full, streaming) counts (a TP rank's), else the pattern's."""
    T, D = duo.max_cache_size, cfg.head_dim
    if decode_only:
        sink, ring = -(-(duo.sink_size + 8) // 8) * 8, -(-(duo.recent_size + 8) // 128) * 128
    else:
        sink, ring = duo.sink_size + duo.prefill_chunk_size, -(-(duo.recent_size + duo.prefill_chunk_size) // 512) * 512
    heads = heads or [(hf, cfg.num_kv_heads - hf) for hf in duo.num_full_kv_heads]
    full = (T // 2) * (D + 4 * 2) if q4 else T * D * 2
    return sum(2 * batch * (hf * full + hs * (sink + ring) * D * 2) for hf, hs in heads)


def phase_eval_efficiency():
    """9c: evals/efficiency.py's functions at the 8B geometry (32 layers,
    random int8 weights, INT4 cache) at 32k, every head full (sparsity 0)
    and half of them (0.5). Every cache's bytes must equal their reckoning
    from the shapes, and the serving pool's at 0.5 must be below 0.0's."""
    import argparse

    import torch

    from duo_attention_tpu_torch.evals import efficiency

    rows = {}
    params = None
    reset_counts()
    for sparsity in EFF_SPARSITIES:
        args = argparse.Namespace(model="Llama-3-8B-Instruct-Gradient-1048k", num_layers=32, attn_pattern=None,
                                  sparsity=sparsity, sink=SINK, recent=RECENT, ctx_len=EVAL_CTX,
                                  prefill_chunk=CHUNK, w8a8=True, kv_quant="int4", batch_size=1, device="cuda")
        engine, cfg, duo = efficiency.build_engine(args, params)
        params = engine.params
        prefill_s, kv = efficiency.bench_prefill(engine, EVAL_CTX, runs=3)
        decode_s, kv_decode = efficiency.bench_decode(engine, EVAL_CTX, steps=64, repeats=3)
        tok_s, kv_pool = efficiency.bench_serving(cfg, duo, EFF_BATCH, EVAL_CTX, kv_quant="int4", steps=64,
                                                  params=params, device="cuda")
        want, want_pool = _kv_bytes_reckoned(cfg, duo, 1), _kv_bytes_reckoned(cfg, duo, EFF_BATCH, True)
        require(kv == kv_decode == want, f"sparsity {sparsity}: KV bytes {kv} / {kv_decode}, reckoned {want}")
        require(kv_pool == want_pool, f"sparsity {sparsity}: pool KV bytes {kv_pool}, reckoned {want_pool}")
        rows[str(sparsity)] = dict(full_heads=sum(duo.num_full_kv_heads), prefill_s=prefill_s,
                                   decode_ms=decode_s * 1e3, serving_tok_s=tok_s, kv_bytes=kv, pool_kv_bytes=kv_pool)
        log(f"  sparsity {sparsity}: {sum(duo.num_full_kv_heads)} full heads; prefill {prefill_s:.3f} s "
            f"({EVAL_CTX / prefill_s:.0f} tok/s), decode {decode_s * 1e3:.3f} ms/token, serving B={EFF_BATCH} "
            f"{tok_s:.1f} tok/s; KV {kv / 2**30:.3f} GiB, pool KV {kv_pool / 2**30:.3f} GiB")
        del engine
        torch.cuda.empty_cache()
    counts = read_counts()
    require(counts["plain_cuda_calls"] == 0, f"9c called plain versions on the card: {counts}")
    full, duo_row = rows[str(EFF_SPARSITIES[0])], rows[str(EFF_SPARSITIES[1])]
    # The serving pool's streaming heads hold sink + recent rows: half the heads streaming must
    # take less memory. The B=1 prefill cache's do not have to: a streaming head keeps a whole
    # chunk of pad beside its sink and a ring of recent + chunk rows in bf16, 8,768 rows at chunk
    # 4096, which weigh about what an INT4 full head's 32k tokens do (reported, not required).
    require(duo_row["pool_kv_bytes"] < full["pool_kv_bytes"], f"pool KV bytes at sparsity 0.5 not below 0.0: {rows}")
    ratios = {k: full[k] / duo_row[k] for k in ("prefill_s", "decode_ms", "kv_bytes", "pool_kv_bytes")}
    ratios["serving_tok_s"] = duo_row["serving_tok_s"] / full["serving_tok_s"]
    log(f"  sparsity 0.0 / 0.5: {json.dumps(ratios)} (serving: 0.5 / 0.0)")
    del params
    torch.cuda.empty_cache()
    return dict(rows=rows, ratios=ratios, counts=counts)


def phase_eval():
    """Phase 9: builds the constructed 8B graft once (niah.build_model, the
    function the CLI builds it with) and runs 9a and 9b on it, then 9c on
    random weights."""
    import torch

    from duo_attention_tpu_torch import load_attn_pattern, sparsify_attention_heads
    from duo_attention_tpu_torch.evals import niah

    out = {}
    t0 = time.perf_counter()
    base, cfg, needle = niah.build_model("constructed-8b", True, "cuda")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    log(f"  constructed-8b W8A8: {sum(t.numel() * t.element_size() for t in _leaves(base)) / 2**30:.2f} GiB "
        f"on the card in {out['build_s']:.1f} s")
    heads, sink, recent = load_attn_pattern(os.path.join(REPO, "artifacts", "niah_8b", "pattern"))
    heads, _ = sparsify_attention_heads(heads, sparsity=0.5)
    for key, label, fn in (("niah", "9a: NIAH, constructed-8b, W8A8KV4",
                            lambda: phase_eval_niah(base, cfg, needle, heads, sink, recent)),
                           ("longbench", "9b: LongBench trec/lsht, constructed-8b, W8A8KV4",
                            lambda: phase_eval_longbench(base, cfg, heads, sink, recent))):
        log(f"phase {label}")
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        log(f"  phase {label.split(':')[0]}: {out[key]['phase_s']:.1f} s")
    del base
    torch.cuda.empty_cache()
    log("phase 9c: efficiency (evals/efficiency.py, 8B geometry, W8A8KV4, 32k, sparsity 0.0 and 0.5)")
    t0 = time.perf_counter()
    out["efficiency"] = phase_eval_efficiency()
    out["efficiency"]["phase_s"] = time.perf_counter() - t0
    log(f"  phase 9c: {out['efficiency']['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: gate training (the constructed circuit at the 8B geometry, W8A8)
# ---------------------------------------------------------------------------


def _train_kinds(events):
    """Device ms of a training window's activities by what they compute: the
    tiled W8A8 product, float32 products (the blockwise attention's: no other
    product of a step is float32), bf16 products (the straight-through
    estimator's: no other product of a W8A8 step is bf16), and the rest
    (elementwise work, reductions, copies); with the tiled kernels' count and
    the products' kernel names."""
    from torch.autograd import DeviceType

    by_kind, names, tiled = {}, {}, 0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == "train_step":
            continue
        if "w8a8_tiled_kernel" in e.name:
            kind = "tiled_w8a8"
            tiled += 1
        elif _kernel_kind(e.name) == "matmul":
            kind = "f32_products" if any(k in e.name for k in ("f32f32", "sgemm")) else "bf16_products"
            names.setdefault(kind, set()).add(e.name[:70])
        else:
            kind = "elementwise_and_other"
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_kind, tiled, {k: sorted(v)[:6] for k, v in names.items()}


def train_breakdown(fn):
    """One training step (fn) under torch.profiler: the window's wall ms, the
    device's busy ms and idle share, device ms by ``_train_kinds``, and the
    tiled kernels the device ran."""
    from torch.profiler import record_function

    def step():
        with record_function("train_step"):
            fn()

    events, wall_ms = _profiled_window(step)
    by_kind, tiled, names = _train_kinds(events)
    busy = sum(by_kind.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=(1 - busy / wall_ms) if busy else None,
                by_kind_ms=by_kind, tiled_kernels=tiled, product_names=names)


def blockwise_layer_breakdown(cfg, S, sink, recent, block_k):
    """One layer's blockwise attention as a training step runs it, alone and
    profiled: the teacher's causal pass without a gradient, then the
    student's Λ pass under a per-layer checkpoint, its backward from a random
    cotangent (the forward, the layer's recompute, the blocks' recomputes and
    the backward). Device ms of its float32 products and of the rest: times
    the layer count, the step's blockwise share."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from duo_attention_tpu_torch.ops.blockwise import blockwise_attention, causal_mask_fn, lambda_mask_fn

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, S, h, cfg.head_dim), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    ct = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    lam = lambda_mask_fn(sink, recent)

    def layer():
        with torch.no_grad():
            blockwise_attention(q, k, v, causal_mask_fn, block_k=block_k)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = checkpoint(lambda a, b, c: blockwise_attention(a, b, c, lam, block_k=block_k), qs, ks, vs,
                         use_reentrant=False)
        out.backward(ct)

    layer()
    events, _ = _profiled_window(layer)
    by_kind, tiled, _ = _train_kinds(events)
    require(tiled == 0 and "bf16_products" not in by_kind, f"blockwise attention ran other products: {by_kind}")
    return by_kind


def _split_breakdown(b, layer, layers):
    """The step's device ms (train_breakdown) split into five
    kinds: its float32 products are the blockwise matmuls; the blockwise
    elementwise work is ``layers`` times one layer's, measured alone; other
    is the step's remaining elementwise work."""
    k = b["by_kind_ms"]
    blockwise_elementwise = layers * layer.get("elementwise_and_other", 0.0)
    return dict(blockwise_matmul=k.get("f32_products", 0.0), blockwise_elementwise=blockwise_elementwise,
                tiled_w8a8=k.get("tiled_w8a8", 0.0), ste_bf16_products=k.get("bf16_products", 0.0),
                other=k.get("elementwise_and_other", 0.0) - blockwise_elementwise,
                blockwise_matmul_alone=layers * layer.get("f32_products", 0.0))


def _train_data(ctx_min, ctx_max, pad_to):
    """The trainer CLI's passkey batches (4 passkeys, padded to a multiple of
    128, then to ``pad_to``), B = 1, word tokens."""
    from duo_attention_tpu_torch.tokenizer import get_tokenizer
    from duo_attention_tpu_torch.train.data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator

    dcfg = PasskeyDataConfig(context_length_min=ctx_min, context_length_max=ctx_max, num_passkeys=TRAIN_PASSKEYS,
                             pad_to_multiple=128)
    return data_iterator(MultiPasskeyDataset(get_tokenizer("word"), dcfg), 1, pad_to=pad_to)


def _train_steps(trainer, it, n, per_step_tiled):
    """n steps of ``trainer``: each step's loss finite, its gates in [0, 1],
    its tiled launches ``per_step_tiled`` and no plain product on the card.
    Returns the per-step records."""
    import torch

    from duo_attention_tpu_torch.ops import gemm

    steps = []
    for _ in range(n):
        batch = next(it)
        tiled, plain = gemm.w8a8_matmul.tiled_launches, gemm.w8a8_matmul_plain.cuda_calls
        t0 = time.perf_counter()
        loss, d, reg = trainer.train_step(batch["input_ids"], batch["labels"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = trainer.gates_numpy()
        launched = gemm.w8a8_matmul.tiled_launches - tiled
        steps.append(dict(step=trainer.step_idx, loss=loss, distill=d, reg=reg, wall_s=wall, tiled=launched,
                          gates_min=float(g.min()), gates_max=float(g.max()), len=int(batch["input_ids"].shape[1])))
        require(np.isfinite(loss) and np.isfinite(d), f"step {trainer.step_idx}: loss {loss}, distill {d}")
        require(0.0 <= g.min() and g.max() <= 1.0, f"step {trainer.step_idx}: gates outside [0, 1]")
        require(launched == per_step_tiled, f"step {trainer.step_idx}: {launched} tiled launches, reckoned "
                f"{per_step_tiled}")
        require(gemm.w8a8_matmul_plain.cuda_calls == plain, f"step {trainer.step_idx} ran a plain product")
    return steps


def phase_train_8b():
    """10a: GateTrainer on constructed-8b (W8A8, built on the card) with
    tests/test_graft_8b.py:141's recipe at scripts/run_niah_8b_tpu.sh's sink,
    recent, passkeys and block: TRAIN_STEPS steps at 1,024-2,048 tokens padded
    to 2,048; one step profiled. Then the trained gates are deployed:
    finalize, load_attn_pattern, sparsify at 0.5, one NIAH cell at 32k, depth
    50%, with phase 9's engine settings. Last, TRAIN_TIME_STEPS steps at the
    TPU recipe's 1,024-4,096 tokens padded to 4,096 for the time a step and
    the peak memory, one more profiled."""
    import torch

    from duo_attention_tpu_torch import load_attn_pattern, sparsify_attention_heads
    from duo_attention_tpu_torch.evals.niah import NIAHConfig, NIAHTester, build_model
    from duo_attention_tpu_torch.models.constructed import LONG_8B_SPEC, ground_truth_heads
    from duo_attention_tpu_torch.models.convert import reorder_params
    from duo_attention_tpu_torch.tokenizer import get_tokenizer
    from duo_attention_tpu_torch.train.trainer import GateTrainConfig, GateTrainer

    out = {}
    gc.collect()  # free what earlier phases left in reference cycles, so it is not freed mid-phase
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold: the peaks below count above it
    t0 = time.perf_counter()
    params, cfg, needle = build_model("constructed-8b", True, "cuda")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    per_step = TILED_PER_LAYER * cfg.num_layers
    pattern_dir = _fresh_dir("train_8b", "pattern", phase="phase10")
    tcfg = GateTrainConfig(lr=TRAIN_LR, reg_weight=TRAIN_REG, num_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
                           sink_size=SINK, recent_size=RECENT, batch_size=1, save_steps=TRAIN_STEPS,
                           output_dir=pattern_dir, block_k=TRAIN_BLOCK)
    reset_counts()
    trainer = GateTrainer(params, cfg, tcfg, device="cuda")
    it = _train_data(*TRAIN_CTX, TRAIN_PAD)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps = _train_steps(trainer, it, TRAIN_STEPS // 2, per_step)
    profiled = {}

    def one_step():
        profiled["steps"] = _train_steps(trainer, it, 1, per_step)

    out["profile_2048"] = train_breakdown(one_step)
    steps += profiled["steps"] + _train_steps(trainer, it, TRAIN_STEPS - TRAIN_STEPS // 2 - 1, per_step)
    out["train_s"] = time.perf_counter() - t0
    out["peak_gib_2048"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["counts"] = read_counts()
    gates = trainer.gates_numpy()
    gt = ground_truth_heads(LONG_8B_SPEC)
    out.update(steps=steps, gates=gates.tolist(), ground_truth=np.argwhere(gt > 0.5).tolist(),
               above_half=np.argwhere(gates > 0.5).tolist())
    walls = [s["wall_s"] for s in steps[1:] if s is not profiled["steps"][0]]
    out["s_per_step_2048"] = float(np.median(walls))
    for s in steps[:: max(TRAIN_STEPS // 8, 1)] + steps[-1:]:
        log(f"  step {s['step']}: loss {s['loss']:.6f} distill {s['distill']:.6f} reg {s['reg']:.4f} "
            f"gates [{s['gates_min']:.3f}, {s['gates_max']:.3f}] tiled {s['tiled']} {s['wall_s']:.3f} s")
    b = out["profile_2048"]
    log(f"  {TRAIN_STEPS} steps at {TRAIN_PAD} tokens in {out['train_s']:.1f} s: {out['s_per_step_2048']:.3f} s a "
        f"step (median), peak {out['peak_gib_2048']:.2f} GiB (weights included); tiled launches {per_step} a step "
        f"({TILED_PER_LAYER} a layer); profiled step: {json.dumps(b)}")
    log(f"  gates > 0.5: {out['above_half']} (ground truth {out['ground_truth']}); layer "
        f"{LONG_8B_SPEC.circuit_layers[1]}: {np.round(gates[LONG_8B_SPEC.circuit_layers[1]], 4).tolist()}; "
        f"max elsewhere {float(np.max(np.where(gt > 0.5, 0.0, gates))):.4f}")
    out["breakdown_2048"] = _split_breakdown(
        b, blockwise_layer_breakdown(cfg, TRAIN_PAD, SINK, RECENT, TRAIN_BLOCK), cfg.num_layers)
    log(f"  one step at {TRAIN_PAD} tokens, device ms by kind: {json.dumps(out['breakdown_2048'])}")
    require(b["tiled_kernels"] == per_step, f"the profiled step ran {b['tiled_kernels']} tiled kernels, the "
            f"counter {per_step}")
    require(out["counts"]["plain_cuda_calls"] == 0, f"10a called plain versions on the card: {out['counts']}")
    require(((gates > 0.5) == (gt > 0.5)).all(), f"trained gates > 0.5 at {out['above_half']}, ground truth "
            f"{out['ground_truth']}")

    # deploy: the artifact, read back, made binary at sparsity 0.5, one NIAH cell
    trainer.finalize()
    heads, sink, recent = load_attn_pattern(pattern_dir)
    require(np.allclose(heads, np.clip(gates, 0, 1), atol=1e-7) and (sink, recent) == (SINK, RECENT),
            "the written pattern does not read back")
    binary, _ = sparsify_attention_heads(heads, sparsity=0.5)
    ref, _, _ = load_attn_pattern(os.path.join(REPO, "artifacts", "niah_8b", "pattern"))
    ref_binary, _ = sparsify_attention_heads(ref, sparsity=0.5)
    out["binary_equals_phase9"] = bool(np.array_equal(binary, ref_binary))
    out["binary_differs_at"] = np.argwhere(binary != ref_binary).tolist()
    del trainer
    torch.cuda.empty_cache()
    reordered, nf = reorder_params(params, cfg, binary)
    engine, clock = _niah_engine(reordered, cfg, nf, sink, recent, NIAH_MAX_CACHE)
    tok = get_tokenizer("word")
    cell = NIAHTester(engine, tok, NIAHConfig(context_lengths=[EVAL_CTX], depth_percents=[50.0], gen_tokens=EVAL_GEN,
                                              output_dir=_fresh_dir("train_8b", "niah", phase="phase10"), resume=False, **needle)
                      ).run_cell(EVAL_CTX, 50.0)
    out["niah_cell"] = dict(word_overlap=cell["word_overlap"], response=cell["response"],
                            latency_s=cell["latency_s"], full_heads=sum(nf))
    log(f"  deployed: binary pattern at 0.5 equals phase 9's: {out['binary_equals_phase9']} (differs at "
        f"{out['binary_differs_at'][:8]}); NIAH ctx {EVAL_CTX} depth 50%: overlap {cell['word_overlap']:.2f} "
        f"response {cell['response']!r}")
    require(cell["word_overlap"] == 1.0, f"the deployed trained pattern missed the needle: {cell}")
    del engine, clock, reordered
    gc.collect()  # the clock's wrappers and the engine hold each other: free the 131k cache now
    torch.cuda.empty_cache()

    # the TPU recipe's length: 3 steps at 4,096 for the time a step and the peak memory, a 4th profiled
    long_trainer = GateTrainer(params, cfg, dataclasses.replace(tcfg, output_dir=_fresh_dir("train_8b", "long", phase="phase10")),
                               device="cuda")
    it = _train_data(TRAIN_CTX[0], TRAIN_LONG_PAD, TRAIN_LONG_PAD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    long_steps = _train_steps(long_trainer, it, TRAIN_TIME_STEPS, per_step)
    out["peak_gib_4096"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["profile_4096"] = train_breakdown(lambda: _train_steps(long_trainer, it, 1, per_step))
    out["long_steps"] = long_steps
    out["s_per_step_4096"] = float(np.median([s["wall_s"] for s in long_steps]))
    out["breakdown_4096"] = _split_breakdown(
        out["profile_4096"], blockwise_layer_breakdown(cfg, TRAIN_LONG_PAD, SINK, RECENT, TRAIN_BLOCK), cfg.num_layers)
    log(f"  {TRAIN_TIME_STEPS} steps at {TRAIN_LONG_PAD} tokens: {[round(s['wall_s'], 3) for s in long_steps]} s, "
        f"peak {out['peak_gib_4096']:.2f} GiB; profiled step: {json.dumps(out['profile_4096'])}; device ms by "
        f"kind: {json.dumps(out['breakdown_4096'])}")
    require(out["profile_4096"]["tiled_kernels"] == per_step, "the 4,096-token profiled step's tiled kernels")
    del long_trainer, params
    torch.cuda.empty_cache()
    return out


def _loop_gates_separate(gates, spec):
    """tests/test_accuracy_loop.py's 80-step bounds: the circuit's two
    retrieval heads above 0.6, every other head below 0.35, a gap above 0.4."""
    from duo_attention_tpu_torch.models.constructed import ground_truth_heads

    gates = np.asarray(gates)
    gt = ground_truth_heads(spec) > 0.5
    retrieval, local = gates[gt], gates[~gt]
    return retrieval.min() > 0.6 and local.max() < 0.35 and retrieval.min() > local.max() + 0.4


def phase_accuracy_loop():
    """10b: evals/accuracy_loop.py::run_loop on the card with LOOP_GATE_STEPS
    gate steps (tests/test_accuracy_loop.py:99-123's recipe length: the JAX
    default of 600 took 266 s on an H100, PERF.md) and the JAX loop's other
    defaults (B = 8, 128-1,024 tokens padded to 1,280, sink 16, recent 64,
    sparsity 0.5, 16 samples, W8A8KV4 variants), on the 64-wide constructed
    circuit of the TPU's record (artifacts/accuracy_loop/report.json), through
    the kernels' head_dim-64 instantiations; its overlaps printed beside the
    record's."""
    import torch

    from duo_attention_tpu_torch.evals.accuracy_loop import run_loop
    from duo_attention_tpu_torch.models.constructed import BASE_SPEC

    with open(os.path.join(REPO, "artifacts", "accuracy_loop", "report.json")) as f:
        record = json.load(f)
    require(record["lm"] == "constructed" and record["model"]["head_dim"] == 64, "the record's circuit changed")
    out = {}
    reset_counts()
    t0 = time.perf_counter()
    report = run_loop(_fresh_dir("accuracy_loop", "constructed", phase="phase10"), gate_steps=LOOP_GATE_STEPS,
                      reuse_lm=False, lm="constructed", device="cuda")
    r = {k: v["word_overlap"] for k, v in report["results"].items()}
    out["constructed"] = dict(phase_s=time.perf_counter() - t0, gates=report["gates"], results=report["results"],
                              teacher_forced_answer_acc=report["teacher_forced_answer_acc"],
                              record_results=record["results"], record_gates=record["gates"])
    log(f"  run_loop, constructed (head_dim 64), {LOOP_GATE_STEPS} gate steps: {out['constructed']['phase_s']:.1f} s; "
        f"gates {np.round(report['gates'], 3).tolist()} (the TPU's record, 600 steps: "
        f"{np.round(record['gates'], 3).tolist()})\n    word overlap, the card beside the TPU's record: "
        + ", ".join(f"{k} {v:.3f} / {record['results'][k]['word_overlap']:.3f}" for k, v in r.items()))
    require(_loop_gates_separate(report["gates"], BASE_SPEC), f"constructed gates {report['gates']}")
    require(min(r["full_attention"], r["trained_pattern"]) >= 0.95, f"full or trained below 0.95: {r}")
    require(min(r["full_attention_w8a8kv4"], r["trained_pattern_w8a8kv4"]) >= 0.90, f"W8A8KV4 below 0.90: {r}")
    require(max(r["inverted_pattern"], r["inverted_pattern_w8a8kv4"]) <= 0.25, f"inverted above 0.25: {r}")
    out["counts"] = read_counts()
    log(f"  launches during 10b: {out['counts']}")
    require(out["counts"]["plain_cuda_calls"] == 0, f"10b called plain versions on the card: {out['counts']}")
    torch.cuda.empty_cache()
    return out


def phase_train():
    out = {}
    for key, label, fn in (("train_8b", "10a: gate training, constructed-8b, W8A8", phase_train_8b),
                           ("accuracy_loop", "10b: evals/accuracy_loop.py::run_loop", phase_accuracy_loop)):
        log(f"phase {label}")
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        log(f"  phase {label.split(':')[0]}: {out[key]['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: Mixtral-8x7B's MoE MLP at the published width
# ---------------------------------------------------------------------------


def _graph_vs_eager_tokens(params, cfg, duo, kv_quant):
    """The engine's decode (its first step eager, then CUDA-graph replays)
    against a loop of eager forward_chunk steps at the same bucket, each from
    its own prefill of the 16,000-token prompt: the NEW_TOKENS greedy tokens
    must be equal."""
    import torch

    from duo_attention_tpu_torch import DuoEngine
    from duo_attention_tpu_torch.models import llama

    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))
    cache, logits = engine.prefill(ids)
    graph, cache = engine.decode_tokens(cache, torch.argmax(logits, -1), NEW_TOKENS, length=PROMPT_LEN)
    del cache
    cache, logits = engine.prefill(ids)
    token, bucket, eager = torch.argmax(logits, -1), engine.bucket_for(PROMPT_LEN + NEW_TOKENS), []
    with torch.no_grad():
        for _ in range(NEW_TOKENS):
            eager.append(int(token[0]))
            hidden, cache = llama.forward_chunk(params, cfg, duo, cache, token[:, None], 1, full_bucket=bucket)
            token = torch.argmax(llama.logits_at(params, hidden, 0), dim=-1)
    graph = [int(t) for t in graph[0]]
    first = next((i for i, (a, b) in enumerate(zip(graph, eager)) if a != b), None)
    log(f"  captured decode against the eager loop: {NEW_TOKENS} tokens, "
        + ("equal" if first is None else f"first difference at {first}"))
    require(first is None, f"captured decode tokens {graph} differ from the eager loop's {eager}")
    del cache
    torch.cuda.empty_cache()
    return dict(equal=True, tokens=graph[:16])


def _moe_layer_breakdown(layer, cfg):
    """Device ms of one MoE MLP (llama._moe_mlp) alone at the decode step's
    shape (one token) and at a prefill chunk's (CHUNK tokens), by kind:
    the expert products (its cuBLAS products less the router's) and the
    router, softmax, combine, SwiGLU and weighted sum (the rest)."""
    import torch

    from duo_attention_tpu_torch.models import llama

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    out = {}
    for label, S in (("decode", 1), ("prefill_chunk", CHUNK)):
        x = torch.randn((1, S, cfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
        moe = device_breakdown(lambda: llama._moe_mlp(layer, x, cfg.num_experts_per_tok))
        router = device_breakdown(lambda: llama.moe_router(layer, x, cfg.num_experts_per_tok))
        experts = moe["by_kind_ms"].get("matmul", 0.0) - router["by_kind_ms"].get("matmul", 0.0)
        out[label] = dict(busy_ms=moe["device_busy_ms"], expert_products_ms=experts,
                          router_and_combine_ms=moe["device_busy_ms"] - experts, router_alone_ms=router["device_busy_ms"])
        del x
    return out


def _step_by_kind(b, moe, layers, scale):
    """A profiled window's device ms by kind (``b`` from device_breakdown),
    divided by ``scale`` (steps, or 1), with the MoE MLP's share taken from
    ``moe`` (one layer alone at the same shape) times the layers: the expert
    products, the router and combine, the attention kernels (the port's
    attention kernels and cache writes), the W8A8 products, and the rest."""
    by = {k: v / scale for k, v in b["by_kind_ms"].items()}
    busy = b["device_busy_ms"] / scale
    attention = sum(v for k, v in by.items() if k in REPLACES and not k.startswith("w8a8"))
    w8a8 = sum(v for k, v in by.items() if k.startswith("w8a8"))
    experts, router = layers * moe["expert_products_ms"], layers * moe["router_and_combine_ms"]
    return dict(device_busy_ms=busy, expert_products_ms=experts, router_and_combine_ms=router,
                attention_kernels_ms=attention, w8a8_products_ms=w8a8,
                other_ms=busy - experts - router - attention - w8a8, cublas_products_ms=by.get("matmul", 0.0))


def phase_mixtral():
    """11: the Mixtral MoE MLP (models/llama.py::_moe_mlp, JAX's dense
    dispatch) at Mixtral-8x7B's published width, depth cut to
    MIXTRAL_LAYERS, random weights from a seed, a synthetic pattern (4 of 8
    KV heads full in every layer, sink 64, recent 256), in bf16 and in
    W8A8KV4 (init_params_w8a8: the 4 attention projections and the head int8,
    the router float32, the experts bf16 as JAX leaves them): phase 4's
    DuoEngine run on the 16,000-token prompt (launch counts, TTFT, decode
    ms/token, idle share, peak memory), the captured decode's tokens against
    an eager loop's, phase 5's kernel path against the plain path over 4
    layers, a ServingEngine run held to isolated runs (phase 8c's checks),
    and the device ms a step by kind beside the bounds of dense dispatch."""
    import torch

    from duo_attention_tpu_torch import DuoConfig, init_params, init_params_w8a8
    from duo_attention_tpu_torch.config import config_from_hf_dict

    published = config_from_hf_dict(MIXTRAL_HF_CONFIG)
    cfg = dataclasses.replace(published, num_layers=MIXTRAL_LAYERS)
    require((cfg.hidden_size, cfg.intermediate_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.vocab_size, cfg.rope_theta, cfg.rms_norm_eps, cfg.num_local_experts, cfg.num_experts_per_tok)
            == (4096, 14336, 32, 8, 128, 32000, 1e6, 1e-5, 8, 2), f"Mixtral config {cfg}")
    duo = DuoConfig(sink_size=SINK, recent_size=RECENT, num_full_kv_heads=(MIXTRAL_FULL_HEADS,) * MIXTRAL_LAYERS,
                    max_cache_size=MAX_CACHE, prefill_chunk_size=CHUNK)
    E, I, X = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    expert_bytes = 3 * X * E * I * 2  # a layer's experts in bf16, every one read under dense dispatch
    bounds = dict(decode_ms_per_token=MIXTRAL_LAYERS * expert_bytes / PEAK_BYTES * 1e3,
                  prefill_s=2 * PROMPT_LEN * MIXTRAL_LAYERS * 3 * X * E * I / PEAK_BF16_FLOPS,
                  expert_gb_per_token=MIXTRAL_LAYERS * expert_bytes / 1e9,
                  prefill_expert_tflop=2 * PROMPT_LEN * MIXTRAL_LAYERS * 3 * X * E * I / 1e12)
    log(f"  Mixtral-8x7B (published config, {published.num_layers} layers) cut to {MIXTRAL_LAYERS}: experts "
        f"{expert_bytes / 1e9:.2f} GB a layer; bounds: decode reads {bounds['expert_gb_per_token']:.1f} GB of experts "
        f"a token, {bounds['decode_ms_per_token']:.2f} ms/token at {PEAK_BYTES / 1e12:.2f} TB/s before attention; "
        f"prefill of {PROMPT_LEN} tokens {bounds['prefill_expert_tflop']:.0f} TFLOP of expert products, "
        f"{bounds['prefill_s']:.3f} s at the bf16 dense peak")
    out = dict(config=dataclasses.asdict(cfg), reduced=dict(num_layers=[published.num_layers, MIXTRAL_LAYERS]),
               bounds=bounds)
    formats = (("bf16", "none", lambda: init_params(cfg, seed=0, device="cuda")),
               ("w8a8kv4", "int4", lambda: init_params_w8a8(cfg, seed=0, device="cuda", quantize_embeds=True)))
    for fmt, kv_quant, make_params in formats:
        t0 = time.perf_counter()
        params = make_params()
        torch.cuda.synchronize()
        log(f"  {fmt} weights: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params, "
            f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB, in "
            f"{time.perf_counter() - t0:.1f} s")
        r = {}
        log(f"  11 {fmt}: DuoEngine.generate")
        r["end_to_end"] = phase_end_to_end(params, cfg, duo, kv_quant)
        r["graph_vs_eager"] = _graph_vs_eager_tokens(params, cfg, duo, kv_quant)
        moe = _moe_layer_breakdown(params["layers"][0], cfg)
        prof = r["end_to_end"]["profile"]
        n_chunks = -(-PROMPT_LEN // CHUNK)
        r["by_kind"] = dict(
            decode_step=_step_by_kind(prof["decode_8_steps"], moe["decode"], MIXTRAL_LAYERS, 8),
            prefill=_step_by_kind(prof["prefill"], {k: n_chunks * v for k, v in moe["prefill_chunk"].items()},
                                  MIXTRAL_LAYERS, 1))
        r["moe_layer"] = moe
        e2e = r["end_to_end"]
        for window, b in r["by_kind"].items():
            log(f"  11 {fmt} {window} device ms by kind: " + ", ".join(f"{k} {v:.3f}" for k, v in b.items()))
        log(f"  11 {fmt}: TTFT {e2e['ttft_ms']:.1f} ms (bound {bounds['prefill_s'] * 1e3:.1f} ms of expert products); "
            f"decode graph {e2e['decode']['graph']['ms_per_token']:.2f} ms/token (bound "
            f"{bounds['decode_ms_per_token']:.2f}), idle {e2e['decode']['graph']['idle_share']:.3f}; peak memory "
            f"{e2e['peak_memory_gib']:.2f} GiB")
        log(f"  11 {fmt}: kernel path vs plain path")
        r["kernel_vs_plain"] = phase_kernel_vs_plain(params, cfg, duo, kv_quant)
        log(f"  11 {fmt}: ServingEngine, {len(MIXTRAL_SERVE_LENS)} requests")
        r["serving"] = phase_serving(params, cfg, duo, kv_quant, MIXTRAL_SERVE_LENS, MIXTRAL_SERVE_NEW,
                                     {1: _serve_sampling()[1]})
        out[fmt] = r
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 12: tensor parallelism (parallel/, torch.distributed)
# ---------------------------------------------------------------------------
# The ranks are new processes (start method spawn) that import this script as a module and run
# the _tp_* functions below. One card runs both ranks of TP = 2 through gloo (NCCL refuses two
# ranks on one GPU): its times are not TP speed figures.


def _tp_formats():
    """format -> (kv_quant, the builder of phases 4 and 6; both take a ``shard`` hook)."""
    from duo_attention_tpu_torch.models.llama import init_params
    from duo_attention_tpu_torch.ops.quant import init_params_w8a8_random

    return {"bf16": ("none", init_params), "w8a8kv4": ("int4", init_params_w8a8_random)}


def _tp_setup():
    """12a's and 12c's model: the 8B geometry and pattern, cut to TP_LAYERS layers."""
    cfg, duo, _ = _model_setup()
    return (dataclasses.replace(cfg, num_layers=TP_LAYERS),
            dataclasses.replace(duo, num_full_kv_heads=duo.num_full_kv_heads[:TP_LAYERS]))


def _weights_gib(params):
    return sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30


def _spawn(fn, tensor, args):
    """parallel.mesh.run_ranks of a phase-12 worker on the card; a rank that
    fails or hangs fails the phase."""
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    try:
        return pmesh.run_ranks(fn, tensor, args=args, device="cuda", timeout_s=TP_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure(f"phase 12, {fn.__name__}: {e}") from e


def _tp_reference(cfg, duo, fmt, ids):
    """The one-process engine on the card (phase 12's yardstick): TP_NEW
    greedy tokens from eager steps, the top-2 logit gap before each, and the
    logits before each [TP_NEW, vocab] (the prefill's last, then each
    step's; ``stream_logits``, as the ranks take theirs). Its weights are
    freed after."""
    import torch

    from duo_attention_tpu_torch import DuoEngine
    from duo_attention_tpu_torch.parallel import dryrun as pdry

    kv_quant, make = _tp_formats()[fmt]
    params = make(cfg, seed=0, device="cuda")
    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant)
    tokens, gaps = pdry.greedy_gaps(engine, ids, TP_NEW)
    out = dict(logits=pdry.stream_logits(engine, ids, tokens)[:, 0], tokens=tokens[0].tolist(), gaps=gaps)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank(mesh, fmt, ids, ref_tokens, serve):
    """12a on one rank of TP = 2 (and 12c after it, ``serve``): the rank's
    slices of the 8B weights built layer by layer from seed 0, then prefill
    and TP_NEW eager greedy tokens, and the logits before each of the
    one-process run's ``ref_tokens`` [1, TP_NEW] fed after the prompt
    (teacher-forced); TTFT, ms/token, peak memory, KV bytes
    against their reckoning from the rank's heads, the collectives and the
    kernel launches of one decode step (counters), and the kernels the
    profiler saw in 2 more steps against the counters."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, kv_memory_bytes
    from duo_attention_tpu_torch.ops import launches
    from duo_attention_tpu_torch.parallel import dryrun as pdry
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    cfg, duo = _tp_setup()
    kv_quant, make = _tp_formats()[fmt]
    t0 = time.perf_counter()
    params = make(cfg, seed=0, device=mesh.device, shard=pmesh.sharder(mesh, cfg, duo))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = DuoEngine(params, cfg, duo, device=mesh.device, kv_quant=kv_quant, mesh=mesh)
    require(not engine.captures, f"a {mesh.backend} mesh must decode eagerly")
    engine.generate(ids[:, :300], max_new_tokens=2)  # warm up cuBLAS, the kernels and the communicator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cache, logits = engine.prefill(ids)
    first = engine._agree(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tokens, cache = engine.decode_tokens(cache, first, TP_NEW, length=ids.shape[1])
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / TP_NEW
    counts = read_counts()
    require(counts["plain_cuda_calls"] == 0, f"rank {mesh.rank}: the TP path called plain versions: {counts}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kv = kv_memory_bytes(cache)
    kv_want = _kv_bytes_reckoned(cfg, duo, 1, heads=engine.shards.heads, q4=kv_quant == "int4")
    require(kv == kv_want, f"rank {mesh.rank}: KV bytes {kv}, reckoned {kv_want}")

    # one more decode step, counted; then two under the profiler against the counters
    names = list(launches.counters())
    state = {"token": torch.as_tensor(tokens[:, -1], device=mesh.device).long()}
    bucket = engine.bucket_for(ids.shape[1] + TP_NEW + 3)

    def steps(n):
        for _ in range(n):
            state["token"] = engine._next_token(cache, state["token"], bucket)

    before = launches.snapshot()
    steps(1)
    step = {n: a - b for n, a, b in zip(names, launches.snapshot(), before) if a != b}
    collectives = {n.removeprefix(launches.COLLECTIVE): step.get(n, 0) for n in names
                   if n.startswith(launches.COLLECTIVE)}
    expected = pmesh.collectives_per_step(mesh, cfg, duo, w8a8=kv_quant == "int4")
    require(collectives == expected, f"rank {mesh.rank}: collectives a step {collectives}, expected {expected}")
    kernels = {n: c for n, c in step.items() if n in _counters()}
    before = launches.snapshot()
    b = device_breakdown(lambda: steps(2))
    counted = {n: a - c for n, a, c in zip(names, launches.snapshot(), before) if a != c and n in _counters()}
    require(b["kernels_ran"] == counted == {n: 2 * c for n, c in kernels.items()},
            f"rank {mesh.rank}: 2 profiled steps ran {b['kernels_ran']}, the counters {counted}, one step {kernels}")
    out = dict(rank=mesh.rank, backend=mesh.backend, tokens=tokens[0].tolist(), ttft_ms=ttft_ms,
               decode_ms_per_token=decode_ms, peak_memory_gib=peak_gib, kv_bytes=kv, kv_bytes_reckoned=kv_want,
               weights_gib=_weights_gib(params), build_s=build_s, counts=counts, collectives_per_step=collectives,
               kernel_launches_per_step=kernels, device_ms_per_step=b["device_busy_ms"] / 2,
               idle_share=b["idle_share"], sharded_layers=sum(s.sharded for s in pmesh.plan_for(mesh, cfg, duo).layers))
    del cache
    stream = pdry.stream_logits(engine, ids, np.asarray(ref_tokens))[:, 0]
    if mesh.rank == 0:
        out["logits"] = stream
    if serve:
        out["serving"] = _tp_serve(mesh, engine, params, cfg, duo, kv_quant)
    return out


def _tp_serve(mesh, single, params, cfg, duo, kv_quant):
    """12c: ServingEngine(mesh=) over a SERVE_SLOTS-slot pool at TP = 2,
    TP_SERVE_LENS prompts, TP_SERVE_NEW new tokens each, one sampled. Each
    greedy request's stream is fed to the isolated TP engine (teacher-forced)
    and every served token must lie within NEAR_TIE of that engine's top
    logit there; and the stream must equal the engine's own greedy one up to
    its first top-2 gap below NEAR_TIE."""
    import torch

    from duo_attention_tpu_torch import Request, ServingEngine, kv_memory_bytes
    from duo_attention_tpu_torch.parallel import dryrun as pdry

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in TP_SERVE_LENS]
    sampling = {1: _serve_sampling()[1]}
    reset_counts()
    engine = ServingEngine(params, cfg, duo, max_batch_size=SERVE_SLOTS, kv_quant=kv_quant, decode_burst=SERVE_BURST,
                           device=mesh.device, mesh=mesh)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt_ids=prompt, max_new_tokens=TP_SERVE_NEW, sampling=sampling.get(rid)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = {r.rid: list(r.generated) for r in engine.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require(counts["plain_cuda_calls"] == 0 and len(served) == len(prompts), f"12c: {counts}, {sorted(served)}")
    agreement = {}
    for i, prompt in enumerate(prompts):
        if i in sampling:
            require(len(served[i]) == TP_SERVE_NEW, f"12c: sampled request {i} served {len(served[i])} tokens")
            continue
        stream = np.asarray(served[i])
        forced = pdry.stream_logits(single, prompt[None], stream[None])[:, 0]  # [n, vocab]
        below = forced.max(axis=-1) - forced[np.arange(len(stream)), stream]  # each served token below the top
        iso, gaps = pdry.greedy_gaps(single, prompt[None], TP_SERVE_NEW)
        iso = iso[0].tolist()
        tie = next((t for t, g in enumerate(gaps) if g < NEAR_TIE), len(gaps))
        prefix = next((t for t, (a, b) in enumerate(zip(served[i], iso)) if a != b), len(iso))
        agreement[i] = dict(agreeing_prefix=prefix, first_near_tie=tie, served=len(served[i]),
                            gap_at_divergence=gaps[prefix] if prefix < len(iso) else None,
                            largest_below_top=float(below.max()), steps_not_argmax=int((below > 0).sum()))
        require(float(below.max()) <= NEAR_TIE, f"12c: request {i}: a served token {below.max():.4f} below the top "
                f"logit of the isolated TP engine fed the same stream (NEAR_TIE {NEAR_TIE}): {below.tolist()}")
        require(prefix >= min(tie, len(iso)), f"12c: request {i} diverged at {prefix} before its first near-tie {tie}")
    out = dict(counts=counts, agreement=agreement, wall_s=wall, pool_kv_bytes=kv_memory_bytes(engine.cache),
               tokens={i: t[:8] for i, t in served.items()})
    del engine
    torch.cuda.empty_cache()
    return out


def _tp1_rank(mesh, fmts):
    """12b, each format in turn: one rank over NCCL, the mesh path with
    graph capture against the no-mesh engine, phase 4's workload: the tokens
    must be bitwise equal; TTFT, the steady graph decode's ms/token and the
    counters a token; then the ServingEngine's (``_tp1_serve``)."""
    return {fmt: _tp1_format(mesh, fmt) for fmt in fmts}


def _tp1_format(mesh, fmt):
    import torch

    from duo_attention_tpu_torch import DuoEngine
    from duo_attention_tpu_torch.ops import launches
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    cfg, duo, _ = _model_setup()
    kv_quant, make = _tp_formats()[fmt]
    params = make(cfg, seed=0, device=mesh.device)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))  # phase 4's prompt
    names = list(launches.counters())
    out = {}
    for label, m in (("no_mesh", None), ("mesh", mesh)):
        local = params if m is None else pmesh.shard_params(mesh, cfg, duo, params)
        engine = DuoEngine(local, cfg, duo, device=mesh.device, kv_quant=kv_quant, mesh=m)
        require(engine.captures, f"12b {label}: the decode is not captured ({mesh.backend})")
        engine.generate(ids[:, :300], max_new_tokens=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = engine.prefill(ids)
        first = engine._agree(torch.argmax(logits, dim=-1))
        torch.cuda.synchronize()
        ttft_ms = (time.perf_counter() - t0) * 1e3
        tokens, cache = engine.decode_tokens(cache, first, NEW_TOKENS, length=PROMPT_LEN)  # captures its graph
        token = torch.as_tensor(tokens[:, -1], device=mesh.device).long()
        torch.cuda.synchronize()
        before = launches.snapshot()
        t0 = time.perf_counter()
        more, cache = engine.decode_tokens(cache, token, NEW_TOKENS, length=PROMPT_LEN + NEW_TOKENS)  # replays
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
        per_token = {n: (a - b) / NEW_TOKENS for n, a, b in zip(names, launches.snapshot(), before) if a != b}
        out[label] = dict(tokens=tokens[0].tolist() + more[0].tolist(), ttft_ms=ttft_ms, graph_ms_per_token=graph_ms,
                          per_token=per_token)
        del engine, cache, local
        torch.cuda.empty_cache()
    require(out["mesh"]["tokens"] == out["no_mesh"]["tokens"],
            f"12b {fmt}: mesh tokens {out['mesh']['tokens']} != no-mesh {out['no_mesh']['tokens']}")
    collectives = {n.removeprefix(launches.COLLECTIVE): out["mesh"]["per_token"].get(n, 0) for n in names
                   if n.startswith(launches.COLLECTIVE)}
    expected = pmesh.collectives_per_step(mesh, cfg, duo, w8a8=kv_quant == "int4")
    require(collectives == expected, f"12b {fmt}: collectives a replayed token {collectives}, expected {expected}")
    out["collectives_per_token"] = collectives
    out["serving"] = _tp1_serve(mesh, params, cfg, duo, kv_quant, fmt)
    del params
    torch.cuda.empty_cache()
    return out


def _tp1_serve(mesh, params, cfg, duo, kv_quant, fmt):
    """12b's ServingEngine: 12c's requests through the no-mesh pool, then
    through ServingEngine(mesh=) on the one-rank NCCL mesh, both capturing
    their pool steps; the served streams must be bitwise equal, and each pool
    step the mesh captured (greedy and sampled) must hold the reckoned
    collectives (replaying it adds them to the counters)."""
    import torch

    from duo_attention_tpu_torch import Request, ServingEngine
    from duo_attention_tpu_torch.ops import launches
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in TP_SERVE_LENS]
    sampling = {1: _serve_sampling()[1]}
    names = list(launches.counters())
    out = {}
    for label, m in (("no_mesh", None), ("mesh", mesh)):
        local = params if m is None else pmesh.shard_params(mesh, cfg, duo, params)
        engine = ServingEngine(local, cfg, duo, max_batch_size=SERVE_SLOTS, kv_quant=kv_quant,
                               decode_burst=SERVE_BURST, device=mesh.device, mesh=m)
        require(engine.captures, f"12b serving {label}: the pool step is not captured ({mesh.backend})")
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt_ids=prompt, max_new_tokens=TP_SERVE_NEW, sampling=sampling.get(rid)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = {r.rid: list(r.generated) for r in engine.run()}
        torch.cuda.synchronize()
        graphs = {f"bucket {bucket}, {'sampled' if sampled else 'greedy'}":
                  {n.removeprefix(launches.COLLECTIVE): d for n, d in zip(names, g.delta)
                   if n.startswith(launches.COLLECTIVE)} for (bucket, sampled), g in engine._graphs.items()}
        out[label] = dict(served=served, wall_s=time.perf_counter() - t0, graphs=graphs)
        del engine, local
        torch.cuda.empty_cache()
    require(out["mesh"]["served"] == out["no_mesh"]["served"],
            f"12b serving {fmt}: mesh streams {out['mesh']['served']} != no-mesh {out['no_mesh']['served']}")
    expected = pmesh.collectives_per_step(mesh, cfg, duo, w8a8=kv_quant == "int4")
    graphs = out["mesh"]["graphs"]
    require(any("greedy" in k for k in graphs) and any("sampled" in k for k in graphs),
            f"12b serving {fmt}: captured pool steps {sorted(graphs)}")
    require(all(c == expected for c in graphs.values()),
            f"12b serving {fmt}: collectives of the captured pool steps {graphs}, expected {expected}")
    return dict(served_tokens=sum(len(t) for t in out["mesh"]["served"].values()), captured_steps=sorted(graphs),
                collectives_per_step=expected, wall_s={k: v["wall_s"] for k, v in out.items()})


def _tp_moe_setup():
    from duo_attention_tpu_torch import DuoConfig
    from duo_attention_tpu_torch.config import config_from_hf_dict

    cfg = dataclasses.replace(config_from_hf_dict(MIXTRAL_HF_CONFIG), num_layers=TP_MOE_LAYERS)
    duo = DuoConfig(sink_size=SINK, recent_size=RECENT, num_full_kv_heads=(MIXTRAL_FULL_HEADS,) * TP_MOE_LAYERS,
                    max_cache_size=MAX_CACHE, prefill_chunk_size=CHUNK)
    return cfg, duo


def _tp_moe_rank(mesh, ids, chosen):
    """12d on one rank: the rank's experts of the Mixtral width (cut to
    TP_MOE_LAYERS layers) built from seed 0, and the prefill logits of
    ``ids`` with the router pinned to the one-process run's experts."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, init_params
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    cfg, duo = _tp_moe_setup()
    params = init_params(cfg, seed=0, device=mesh.device, shard=pmesh.sharder(mesh, cfg, duo))
    engine = DuoEngine(params, cfg, duo, device=mesh.device, mesh=mesh)
    reset_counts()
    with _PinnedRouting() as pinned:
        pinned.chosen, pinned.replay = [torch.as_tensor(c, device=mesh.device) for c in chosen], True
        _, logits = engine.prefill(ids)
        require(pinned.calls == len(chosen), f"12d: {pinned.calls} router calls of {len(chosen)}")
    counts = read_counts()
    return dict(local_experts=params["layers"][0]["experts_w_gate"].shape[0], counts=counts,
                logits=logits[0].float().cpu().numpy() if mesh.rank == 0 else None, weights_gib=_weights_gib(params))


def _hold_logits(label, got, want, kv_quant):
    """Phase 5's bound for the format at every row of got and want ([vocab],
    or [n, vocab]: a teacher-forced stream, [0] the prefill's last logits,
    then each decode step's): |dlogit| <= 5% (W8A8KV4: 10%) of the row's
    largest reference logit + 0.05."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    errs = np.abs(got - want).max(axis=-1)
    bounds = (0.1 if kv_quant == "int4" else 0.05) * np.abs(want).max(axis=-1) + 0.05
    worst = int(np.argmax(errs / bounds))
    steps = (f"; over the {len(errs) - 1} teacher-forced decode steps at most {errs[1:].max():.4f}, nearest its "
             f"bound at step {worst} ({errs[worst]:.4f} of {bounds[worst]:.4f})" if len(errs) > 1 else "")
    log(f"  {label}: max |dlogit| {errs[0]:.4f} against the one-process run at the prefill (bound {bounds[0]:.4f})"
        f"{steps}; argmax equal at {int((got.argmax(-1) == want.argmax(-1)).sum())} of {len(errs)}")
    require(bool(np.isfinite(got).all()) and bool((errs <= bounds).all()),
            f"{label}: logits beyond the bound at steps {np.nonzero(errs > bounds)[0].tolist()}: {errs.tolist()}")
    out = dict(max_abs_logit_err=float(errs.max()), bound=float(bounds[0]))
    if len(errs) > 1:
        out.update(prefill_err=float(errs[0]), decode_max_err=float(errs[1:].max()), worst_step=worst,
                   worst_bound=float(bounds[worst]))
    return out


def phase_tp():
    """12: tensor parallelism on torch.distributed (parallel/), through both
    engines; see the module docstring. Each sub-phase's ranks are spawned
    processes that build their own slices of the weights from the seed."""
    import torch

    from duo_attention_tpu_torch.parallel import dryrun as pdry

    cfg, duo = _tp_setup()
    out = {"note": "one H100 runs both ranks of TP = 2 (gloo): its times are not TP speed figures"}
    ids = np.random.default_rng(12).integers(0, cfg.vocab_size, (1, TP_PROMPT))
    for fmt in ("bf16", "w8a8kv4"):
        t0 = time.perf_counter()
        kv_quant = _tp_formats()[fmt][0]
        ref = _tp_reference(cfg, duo, fmt, ids)
        ranks = _spawn(_tp_rank, TP, (fmt, ids, [ref["tokens"]], fmt == "w8a8kv4"))
        r = dict(ref_tokens=ref["tokens"], ranks=[{k: v for k, v in x.items() if k != "logits"} for x in ranks])
        r["logits"] = _hold_logits(f"12a {fmt}, prefill of {TP_PROMPT} and {TP_NEW - 1} steps fed the one-process "
                                   f"tokens", ranks[0]["logits"], ref["logits"], kv_quant)
        require(ranks[0]["tokens"] == ranks[1]["tokens"], f"12a {fmt}: the ranks' tokens differ")
        got = ranks[0]["tokens"]
        tie = next((t for t, g in enumerate(ref["gaps"]) if g < NEAR_TIE), TP_NEW)
        prefix = next((t for t, (a, b) in enumerate(zip(got, ref["tokens"])) if a != b), TP_NEW)
        r.update(agreeing_prefix=prefix, first_near_tie=tie)
        log(f"  12a {fmt}: TP = 2 tokens agree with the one-process run for {prefix} of {TP_NEW}; its first "
            f"near-tie (top-2 gap < {NEAR_TIE}) at {tie}")
        require(prefix >= min(tie, TP_NEW), f"12a {fmt}: diverged at {prefix} before the first near-tie {tie}")
        for x in ranks:
            log(f"  12a {fmt} rank {x['rank']} ({x['backend']}; one card runs both ranks: not a TP speed figure): "
                f"TTFT {x['ttft_ms']:.1f} ms, decode {x['decode_ms_per_token']:.2f} ms/token (eager), "
                f"{x['device_ms_per_step']:.3f} device ms a step, peak {x['peak_memory_gib']:.2f} GiB "
                f"(weights {x['weights_gib']:.2f} GiB, built in {x['build_s']:.1f} s), KV {x['kv_bytes']} bytes = "
                f"reckoned {x['kv_bytes_reckoned']}; {x['sharded_layers']} head-sharded layers; collectives a step "
                f"{x['collectives_per_step']}; kernel launches a step {x['kernel_launches_per_step']} "
                f"(= the profiler's over 2 steps / 2)")
        if fmt == "w8a8kv4":
            c = ranks[0]["serving"]
            log(f"  12c ServingEngine(mesh=) TP = 2, W8A8KV4, {len(TP_SERVE_LENS)} requests: wall {c['wall_s']:.2f} s "
                f"(not a TP speed figure); pool KV {c['pool_kv_bytes']} bytes a rank; agreement with the isolated "
                f"TP engine {json.dumps(c['agreement'])}")
        r["phase_s"] = time.perf_counter() - t0
        out["tp2_" + fmt] = r
        log(f"  12a{'/12c' if fmt == 'w8a8kv4' else ''} {fmt}: {r['phase_s']:.1f} s")
    t0 = time.perf_counter()
    (tp1,) = _spawn(_tp1_rank, 1, (("bf16", "w8a8kv4"),))
    out["tp1_phase_s"] = time.perf_counter() - t0
    for fmt, b in tp1.items():
        out["tp1_" + fmt] = b
        log(f"  12b {fmt}, TP = 1 over NCCL, graph decode: {PROMPT_LEN} + {2 * NEW_TOKENS} tokens bitwise equal to "
            f"the no-mesh engine's; TTFT {b['mesh']['ttft_ms']:.1f} / {b['no_mesh']['ttft_ms']:.1f} ms, graph "
            f"{b['mesh']['graph_ms_per_token']:.2f} / {b['no_mesh']['graph_ms_per_token']:.2f} ms/token (mesh / "
            f"no mesh); collectives a replayed token {b['collectives_per_token']}")
        c = b["serving"]
        log(f"  12b {fmt} ServingEngine(mesh=), TP = 1 over NCCL: {c['served_tokens']} served tokens bitwise equal to "
            f"the no-mesh pool's; captured pool steps {c['captured_steps']}, collectives each "
            f"{c['collectives_per_step']}; wall {c['wall_s']['mesh']:.2f} / {c['wall_s']['no_mesh']:.2f} s "
            f"(mesh / no mesh)")
    log(f"  12b: {out['tp1_phase_s']:.1f} s")
    t0 = time.perf_counter()
    mcfg, mduo = _tp_moe_setup()
    mids = np.random.default_rng(13).integers(0, mcfg.vocab_size, (1, TP_MOE_PROMPT))
    from duo_attention_tpu_torch import DuoEngine, init_params

    params = init_params(mcfg, seed=0, device="cuda")
    with _PinnedRouting() as pinned:
        _, logits = DuoEngine(params, mcfg, mduo, device="cuda").prefill(mids)
    chosen, want = [c.cpu().numpy() for c in pinned.chosen], logits[0].float().cpu().numpy()
    del params, logits, pinned
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn(_tp_moe_rank, TP, (mids, chosen))
    require([x["local_experts"] for x in ranks] == [mcfg.num_local_experts // TP] * TP, "12d: experts a rank")
    d = dict(logits=_hold_logits(f"12d Mixtral width, {TP_MOE_LAYERS} layers, prefill of {TP_MOE_PROMPT}, "
                                 f"{mcfg.num_local_experts // TP} experts a rank", ranks[0]["logits"], want, "none"),
             counts=[x["counts"] for x in ranks], weights_gib=[x["weights_gib"] for x in ranks],
             phase_s=time.perf_counter() - t0)
    out["tp2_mixtral"] = d
    log(f"  12d: {d['phase_s']:.1f} s")
    t0 = time.perf_counter()
    try:
        out["dryrun"] = pdry.dryrun_step(TP, device="cuda", timeout_s=TP_TIMEOUT_S)
    except (RuntimeError, TimeoutError, AssertionError) as e:
        raise SmokeFailure(f"phase 12 dry runs: {e}") from e
    out["dryrun"]["phase_s"] = time.perf_counter() - t0
    log(f"  12 dry runs (parallel/dryrun.py dryrun_step({TP}) on the card): {out['dryrun']['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: pipeline stages, the gate-training layouts, the 1M-token decode
# ---------------------------------------------------------------------------


def phase_kernels_13(rec):
    """Phase 3 at phase 13's new shapes: the tiled product at M = SP13_LOCAL
    (a 2,048-token step's local length at sp = 2, 13c) at the five 8B weight
    shapes; the INT4 decode and the streaming decode at 13d's span (one KV
    head of 128 a rank, its query group of 4, cs = CTX_1M - 8, bucket
    CTX_1M; the streaming buffers of 13d's window: sink 64 + chunk 512 rows,
    ring round_up(256 + 512, 512)), with the INT4 decode's split plan and
    the largest element offset into its buffers (int32 must hold it)."""
    import torch
    import torch.nn.functional as F

    from duo_attention_tpu_torch.cache import full_mask, ring_mask, sink_mask
    from duo_attention_tpu_torch.ops import flash, quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1313)
    for label, (N, K) in GEMM_SHAPES.items():
        _gemm_case(rec, gen, f"sp2 {label}", N, K, SP13_LOCAL, torch.float32 if label == "head" else torch.bfloat16)
    torch.cuda.empty_cache()

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * mul).to(torch.bfloat16)

    D, G, H, T = HEAD_DIM, GROUP, 1, CTX_1M
    cs, Hq = T - 8, GROUP
    kq, ks = quant.quantize_int4_paired(randn(1, H, T, D))
    vq, vs = quant.quantize_int4_paired(randn(1, H, T, D))
    largest = max(t.numel() for t in (kq, ks, vq, vs)) - 1
    require(largest < 2**31, f"1M INT4 buffers: largest element offset {largest} overflows int32")
    nsplit, split_keys = flash.q4_decode_split_plan(T, H)
    require(nsplit <= 32 and nsplit * split_keys >= T, f"1M INT4 decode plan {nsplit} x {split_keys}")
    q = randn(1, 1, Hq, D, mul=Q_PEAK)
    cs_arg = torch.tensor(cs, dtype=torch.int32, device=dev)
    call = lambda: flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs_arg, bucket=T)  # noqa: E731
    plain = lambda: flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, cs_arg, bucket=T)  # noqa: E731
    err, ratio, ok = _attn_tol_ok(call(), plain(), q4=True)
    mask = full_mask(cs + torch.arange(1, device=dev), T)[None, None]
    kd = quant.dequantize_int4_paired(kq, ks).bfloat16().repeat_interleave(G, dim=1)
    vd = quant.dequantize_int4_paired(vq, vs).bfloat16().repeat_interleave(G, dim=1)
    times = timed(call, plain, lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kd, vd, attn_mask=mask))
    nbytes = 2 * (2 * Hq * D) + 2 * H * (cs + 1) * (D // 2 + 4)
    rec.record("full_cache_attention_q4.decode", f"1M span Hkv=1 cs={cs} bucket {T}", err, ok, times,
               _bound(4 * D * Hq * (cs + 1), nbytes), ratio, nsplit=nsplit, split_keys=split_keys,
               largest_offset=largest)
    log(f"    1M INT4 decode: plan {nsplit} splits x {split_keys} keys; largest buffer offset {largest} (< 2^31)")
    del kq, ks, vq, vs, kd, vd, mask
    torch.cuda.empty_cache()
    sink, recent, chunk = 64, 256, 512
    Ts, R = sink + chunk, -(-(recent + chunk) // 512) * 512
    sk, sv, rk, rv = randn(1, H, Ts, D), randn(1, H, Ts, D), randn(1, H, R, D), randn(1, H, R, D)
    qpos = cs + torch.arange(1, device=dev)
    smask = torch.cat([sink_mask(qpos, sink, sink), ring_mask(qpos, R, cs + 1, cs, sink, recent)], dim=-1)[None, None]
    kc = torch.cat([sk[:, :, :sink], rk], dim=2).repeat_interleave(G, dim=1)
    vc = torch.cat([sv[:, :, :sink], rv], dim=2).repeat_interleave(G, dim=1)
    tot = cs_arg + 1
    call = lambda: flash.streaming_cache_attention(q, sk, sv, rk, rv, cs_arg, tot, sink, recent)  # noqa: E731
    plain = lambda: flash.streaming_cache_attention_plain(q, sk, sv, rk, rv, cs_arg, tot, sink, recent)  # noqa: E731
    err, ratio, ok = _attn_tol_ok(call(), plain())
    times = timed(call, plain, lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kc, vc, attn_mask=smask))
    visible = int(smask.sum())
    rec.record("streaming_cache_attention.decode", f"1M cs={cs} Hs=1 sink {sink} recent {recent}", err, ok, times,
               _bound(4 * D * Hq * visible, 2 * (2 * Hq * D) + 2 * 2 * H * D * visible), ratio)
    torch.cuda.empty_cache()


def phase_pipeline(params, cfg, duo, kv_quant="none"):
    """13a: parallel/pipeline.py's PipelinedEngine, PP stages (balanced: 16
    and 16 layers) both on the card, on phase 4's weights and workload
    (16,000-token prompt, 64 greedy tokens): its prefill logits and tokens
    bitwise DuoEngine's in the same buckets; launch counts as phase 4
    reckons them; each stage's KV bytes equal to their reckoning; kernel
    launches a token (counters) equal to the profiler's over 8 steps; TTFT
    and eager ms/token (the stages share the card: no pipeline speed figure)."""
    import torch

    from duo_attention_tpu_torch import DuoEngine, kv_memory_bytes
    from duo_attention_tpu_torch.ops import launches
    from duo_attention_tpu_torch.parallel import dryrun as pdry
    from duo_attention_tpu_torch.parallel.pipeline import PipelinedEngine

    q4 = kv_quant == "int4"
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT_LEN))  # phase 4's prompt
    one = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant)
    cache, want_logits = one.prefill(ids)
    want_tokens, cache = one.decode_tokens(cache, torch.argmax(want_logits, dim=-1), NEW_TOKENS, length=PROMPT_LEN)
    del cache, one
    torch.cuda.empty_cache()
    pipe = PipelinedEngine(params, cfg, duo, devices=[torch.device("cuda", 0)] * PP, dtype=torch.bfloat16,
                           kv_quant=kv_quant)
    require(pipe.shares_a_card and pipe.bounds == [0, 16, 32], f"13a stages {pipe.bounds} on {pipe.devices}")
    pipe.generate(ids[:, :300], 2)  # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    caches, logits = pipe.prefill(ids)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tokens, caches = pipe.decode_tokens(caches, torch.argmax(logits, dim=-1), NEW_TOKENS, PROMPT_LEN)
    torch.cuda.synchronize()
    ms_per_token = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    counts = read_counts()
    n_chunks = -(-PROMPT_LEN // CHUNK)
    expected = _expected_launches(cfg, duo, q4, n_chunks, NEW_TOKENS)
    if q4:  # the pipeline's prefill takes the head once, after its last chunk (JAX's does); DuoEngine's a chunk
        expected["w8a8_matmul.small"] -= n_chunks - 1
    require(counts == expected, f"13a launch counts {counts} != expected {expected}")
    out = dict(ttft_ms=ttft_ms, eager_ms_per_token=ms_per_token, counts=counts, bounds=pipe.bounds,
               logits_bitwise=bool(torch.equal(logits, want_logits)), tokens_bitwise=bool(np.array_equal(tokens,
                                                                                                         want_tokens)))
    if not (out["logits_bitwise"] and out["tokens_bitwise"]):
        # not bitwise: phase 5's bound on the prefill logits, and tokens equal up to the first near-tie
        out["logits"] = _hold_logits(f"13a {kv_quant} pipeline prefill", logits[0].float().cpu().numpy(),
                                     want_logits[0].float().cpu().numpy(), kv_quant)
        _, gaps = pdry.greedy_gaps(DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant), ids, NEW_TOKENS)
        out["first_difference"] = pdry.agree_until_tie(tokens, want_tokens, gaps, NEAR_TIE, "13a pipeline")
    stage_kv = [kv_memory_bytes(c) for c in caches]
    reckoned = [_kv_bytes_reckoned(c, d, 1, q4=q4) for c, d in zip(pipe.stage_cfgs, pipe.stage_duos)]
    require(stage_kv == reckoned, f"13a stage KV bytes {stage_kv} != reckoned {reckoned}")
    length = PROMPT_LEN + NEW_TOKENS
    token = torch.as_tensor(tokens[:, -1], device="cuda")
    before = launches.snapshot()
    pipe.decode_tokens(caches, token, 1, length)
    per_token = {n: a - b for n, a, b in zip(launches.counters(), launches.snapshot(), before) if a != b}
    prof = device_breakdown(lambda: pipe.decode_tokens(caches, token, 8, length + 1))
    counted = {n: 8 * c for n, c in per_token.items() if n in REPLACES}
    require(prof["kernels_ran"] == counted, f"13a: the device ran {prof['kernels_ran']} in 8 steps, the counters "
            f"say 8 x {per_token}")
    out.update(stage_kv_bytes=stage_kv, kernel_launches_per_token=per_token,
               device_ms_per_step=prof["device_busy_ms"] / 8, idle_share=prof["idle_share"])
    log(f"  13a {kv_quant}: PP = {PP} (layers {pipe.bounds}) on one card, {PROMPT_LEN} + {NEW_TOKENS} tokens: prefill "
        f"logits bitwise DuoEngine's: {out['logits_bitwise']}, tokens: {out['tokens_bitwise']}; TTFT {ttft_ms:.1f} ms, "
        f"eager {ms_per_token:.2f} ms/token, {out['device_ms_per_step']:.3f} device ms a step (stages share the card: "
        f"not a pipeline speed figure); stage KV bytes {stage_kv} = reckoned; launches a token {per_token} = the "
        f"profiler's over 8 steps / 8")
    del caches, pipe
    torch.cuda.empty_cache()
    return out


def phase_niah_pp():
    """13b: evals/niah.py's CLI with ``--pp 2`` (both stages on the card),
    unquantized as JAX's --pp requires. constructed-8b is built only in
    W8A8, which --pp refuses, so this runs the 64-wide long-range circuit
    (constructed-long, head_dim 64: the .d64 kernels) with its TPU-trained
    pattern (artifacts/accuracy_loop_long/pattern) at sparsity 0.5: 32k
    context, depths 0/50/100%, chunk 4096. Every cell's word overlap 1.00,
    and the responses equal to the one-device CLI's."""
    from duo_attention_tpu_torch.evals import niah

    args = ["--model", "constructed-long", "--attn-pattern",
            os.path.join(REPO, "artifacts", "accuracy_loop_long", "pattern"), "--ctx", str(EVAL_CTX), "--depths",
            str(PP_NIAH_DEPTHS), "--prefill-chunk", str(CHUNK), "--max-cache", str(NIAH_SMALL_CACHE)]
    reset_counts()
    t0 = time.perf_counter()
    pp = niah.main(args + ["--pp", str(PP), "--output-dir", _fresh_dir("niah_pp", phase="phase13")])
    pp_s = time.perf_counter() - t0
    counts = read_counts()
    one = niah.main(args + ["--output-dir", _fresh_dir("niah_one", phase="phase13")])
    strip = lambda rs: [{k: v for k, v in r.items() if k != "latency_s"} for r in rs]  # noqa: E731
    require(all(r["word_overlap"] == 1.0 for r in pp), f"13b: --pp cells {[r['word_overlap'] for r in pp]}")
    require(strip(pp) == strip(one), f"13b: --pp responses differ from one device's: {strip(pp)} vs {strip(one)}")
    log(f"  13b niah.main(--pp {PP}) constructed-long at {EVAL_CTX}: overlaps "
        f"{[(r['depth_percent'], r['word_overlap']) for r in pp]}, responses = the one-device CLI's; "
        f"{pp_s:.1f} s (stages share the card)")
    return dict(cells=strip(pp), seconds=pp_s, counts=counts,
                latency_s=[(r["depth_percent"], r["latency_s"]) for r in pp])


def _train13_model(layers):
    """13c's model: constructed-8b in W8A8, built on the card, cut to its
    first ``layers`` layers."""
    from duo_attention_tpu_torch.evals.niah import build_model

    params, cfg, _ = build_model("constructed-8b", True, "cuda")
    params["layers"] = params["layers"][:layers]
    return params, dataclasses.replace(cfg, num_layers=layers)


def _train13_tcfg(out_dir, **kw):
    from duo_attention_tpu_torch.train.trainer import GateTrainConfig

    return GateTrainConfig(**{**dict(lr=TRAIN_LR, reg_weight=TRAIN_REG, num_steps=TRAIN_STEPS,
                                     warmup_steps=TRAIN_WARMUP, sink_size=SINK, recent_size=RECENT,
                                     output_dir=out_dir, block_k=TRAIN_BLOCK), **kw})


def _train13_rank(mesh, layers, batches, out_dir):
    """13c on one rank of the (data 1, seq 2) mesh: the model built on the
    card once, then GateTrainer(sp = 2) and GateTrainer(sp = 2, fsdp) in
    turn (the whole params freed before the FSDP trainer's steps, so it
    holds only its slices), each from gates SP13_GATES, one step a batch:
    losses, gates, s a step, the step's training collectives, the kernels'
    launches, the rank's layer bytes and its peak memory over the steps."""
    import torch

    from duo_attention_tpu_torch.parallel import fsdp as pfsdp
    from duo_attention_tpu_torch.parallel import mesh as pmesh
    from duo_attention_tpu_torch.train.trainer import GateTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params, cfg = _train13_model(layers)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {}
    for label, fsdp in (("sp2", False), ("sp2_fsdp", True)):
        trainer = GateTrainer(params, cfg, _train13_tcfg(os.path.join(out_dir, label), sp=SP13, fsdp=fsdp),
                              mesh=mesh)
        if fsdp:
            params = None  # the FSDP trainer keeps its slices alone
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            trainer.gates.fill_(SP13_GATES)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        steps = []
        for ids, labels in batches:
            before = pmesh.train_collectives()
            t1 = time.perf_counter()
            loss = trainer.train_step(ids, labels)
            torch.cuda.synchronize()
            steps.append(dict(loss=loss, gates=trainer.gates_numpy(), wall_s=time.perf_counter() - t1,
                              collectives={k: v - before[k] for k, v in pmesh.train_collectives().items()}))
        out[label] = dict(rank=mesh.rank, steps=steps, counts=read_counts(), build_s=build_s,
                          layer_bytes=sum(pfsdp.layer_bytes(trainer.params)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del trainer
    return out


def _train13_reference(batches):
    """The one-process step that 13c's meshes must give, twice (block 1024 and
    512: the same attention summed in another order): GateTrainer on the
    whole sequence from gates SP13_GATES, its distillation gradient times N =
    SP13 (JAX's sharded step, duo_attention_tpu/train/trainer.py:140) plus
    the L1 term's, then AdamW and the clamp: for each run, (loss, distill,
    reg) and the gates after each step."""
    import torch

    from duo_attention_tpu_torch.train.loss import l1_loss
    from duo_attention_tpu_torch.train.trainer import GateTrainer

    params, cfg = _train13_model(SP13_LAYERS)
    runs = []
    for block_k in (TRAIN_BLOCK, TRAIN_BLOCK // 2):
        trainer = GateTrainer(params, cfg, _train13_tcfg(_fresh_dir("train_ref", phase="phase13"), reg_weight=0.0,
                                                          block_k=block_k), device="cuda")
        with torch.no_grad():
            trainer.gates.fill_(SP13_GATES)
        out = []
        for ids, labels in batches:
            _, d, _ = trainer.compute_grads(ids, labels)  # the distillation term alone (reg_weight 0)
            trainer.gates.grad.mul_(SP13)
            reg = l1_loss(trainer.gates)
            (TRAIN_REG * reg).backward()
            trainer.apply_grads()
            d, reg = float(d), float(reg.detach())
            out.append(dict(loss=(d + TRAIN_REG * reg, d, reg), gates=trainer.gates_numpy()))
        runs.append(out)
        del trainer
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_train_layouts():
    """13c: gate training on a (data 1, seq 2) mesh over gloo, both ranks on
    the card: constructed-8b in W8A8 (cut to SP13_LAYERS layers), SP13_STEPS
    steps of TRAIN_PAD tokens (SP13_LOCAL a rank: the STE's tiled products at
    M = SP13_LOCAL), sp = 2 with Ulysses, then sp = 2 with FSDP, on one spawn
    of the two ranks (one build of the model a rank). The losses
    and the gates after each step equal the one-process step with JAX's
    N-scaled gradient within a bound taken from two one-process runs (block
    1024 and 512: the same attention summed in another order): 4 times their
    largest difference, and at least 1e-5 of the value; the collectives a
    step as train/trainer.py::collectives_per_step reckons them; FSDP's peak
    memory a rank below the replicated one's."""
    from duo_attention_tpu_torch.parallel import mesh as pmesh
    from duo_attention_tpu_torch.train.trainer import collectives_per_step

    it = _train_data(*TRAIN_CTX, TRAIN_PAD)
    batches = [(b["input_ids"], b["labels"]) for b in (next(it) for _ in range(SP13_STEPS))]
    t0 = time.perf_counter()
    refs = _train13_reference(batches)
    ref_s = time.perf_counter() - t0
    ref = refs[0]
    spread_loss = max(abs(a - b) for r0, r1 in zip(*refs) for a, b in zip(r0["loss"], r1["loss"]))
    spread_gates = max(float(np.abs(r0["gates"] - r1["gates"]).max()) for r0, r1 in zip(*refs))
    out = dict(reference=[dict(loss=r["loss"], gates=r["gates"].tolist()) for r in ref], reference_s=ref_s,
               spread=dict(loss=spread_loss, gates=spread_gates),
               note="both ranks share one card through gloo: no time here is a sequence-parallel speed figure")
    log(f"  13c one-process reference ({SP13_LAYERS} layers, {SP13_STEPS} steps of {TRAIN_PAD}, gradient x {SP13}): "
        f"losses {[r['loss'] for r in ref]}; block 1024 against 512: loss {spread_loss:.3e}, gates "
        f"{spread_gates:.3e}")
    t0 = time.perf_counter()
    try:
        both = pmesh.run_ranks(_train13_rank, SP13, 1, args=(SP13_LAYERS, batches, _fresh_dir("ranks", phase="phase13")),
                               device="cuda", timeout_s=TP_TIMEOUT_S, inner="seq")
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure(f"13c: {e}") from e
    out["ranks_s"] = time.perf_counter() - t0
    for label, fsdp in (("sp2", False), ("sp2_fsdp", True)):
        ranks = [x[label] for x in both]
        r = dict(ranks=[{k: v for k, v in x.items() if k != "steps"} for x in ranks])
        for i, (want, *got) in enumerate(zip(ref, *[x["steps"] for x in ranks])):
            for g in got:
                dl = max(abs(a - b) for a, b in zip(g["loss"], want["loss"]))
                dg = float(np.abs(g["gates"] - want["gates"]).max())
                bl = max(4 * spread_loss, 1e-5 * max(abs(v) for v in want["loss"]))
                bg = max(4 * spread_gates, 1e-5)
                require(dl <= bl and dg <= bg, f"13c {label} step {i}: loss off by {dl} (bound {bl}), gates by "
                        f"{dg} (bound {bg})")
                r.setdefault("errors", []).append(dict(step=i, loss=dl, loss_bound=bl, gates=dg, gates_bound=bg))
            require(all(np.array_equal(g["gates"], got[0]["gates"]) for g in got), f"13c {label}: the ranks' gates differ")
        tcfg = _train13_tcfg("unused", sp=SP13, fsdp=fsdp)
        reckoned = collectives_per_step(dataclasses.replace(_model_setup()[0], num_layers=SP13_LAYERS), tcfg)
        for x in ranks:
            for st in x["steps"]:
                require(st["collectives"] == reckoned, f"13c {label} rank {x['rank']}: collectives {st['collectives']}"
                        f", reckoned {reckoned}")
        r.update(collectives_per_step=reckoned, s_per_step=[[st["wall_s"] for st in x["steps"]] for x in ranks],
                 peak_gib=[x["peak_gib"] for x in ranks], layer_bytes=[x["layer_bytes"] for x in ranks],
                 counts=[x["counts"] for x in ranks], losses=[st["loss"] for st in ranks[0]["steps"]])
        out[label] = r
        log(f"  13c {label}: {SP13_STEPS} steps equal to the one-process step within the bound "
            f"({json.dumps(r['errors'][-2:])}); s a step {r['s_per_step']} (gloo, one card: not a speed figure); "
            f"peak {[round(p, 2) for p in r['peak_gib']]} GiB a rank; layer bytes a rank {r['layer_bytes']}; "
            f"collectives a step {reckoned} = reckoned")
    saved = out["sp2"]["peak_gib"][0] - out["sp2_fsdp"]["peak_gib"][0]
    half_layers = (out["sp2"]["layer_bytes"][0] - out["sp2_fsdp"]["layer_bytes"][0]) / 2**30
    out["fsdp_peak_saving_gib"], out["fsdp_layer_saving_gib"] = saved, half_layers
    require(saved > 0, f"13c: FSDP's peak {out['sp2_fsdp']['peak_gib']} is not below the replicated one's "
            f"{out['sp2']['peak_gib']}")
    log(f"  13c FSDP peak a rank {saved:.2f} GiB below the replicated one's; the rank's layer slices hold "
        f"{half_layers:.2f} GiB less; the ranks (both meshes, one spawn) {out['ranks_s']:.1f} s, the reference "
        f"{ref_s:.1f} s")
    return out


def _train13_counts(out):
    return {f"train13_{label}_rank{i}": c for label in ("sp2", "sp2_fsdp") for i, c in enumerate(out[label]["counts"])}


def phase_1m():
    """13d: parallel/dryrun.py::dryrun_1m_decode(4): one decode step against
    the true 1,048,576-slot INT4 cache on 4 gloo ranks sharing the card (1
    full and 1 streaming head of 128 a layer a rank), finite logits, every
    rank's KV bytes equal to their reckoning; then the same step in this
    process on a whole cache of the same length, and the TP = 4 logits held
    to it within phase 5's bound. (dryrun_step's pipeline and training steps
    ran on 2 ranks of the card in phase 12's dryrun_step(2).)"""
    import torch

    from duo_attention_tpu_torch.parallel import dryrun as pdry

    t0 = time.perf_counter()
    try:
        r = pdry.dryrun_1m_decode(TP_1M, ctx=CTX_1M, device="cuda", timeout_s=TP_TIMEOUT_S)
    except (RuntimeError, TimeoutError, AssertionError) as e:
        raise SmokeFailure(f"13d dryrun_1m_decode: {e}") from e
    ranks_s = time.perf_counter() - t0
    require(r["kv_bytes"] == r["kv_bytes_reckoned"], f"13d KV bytes {r['kv_bytes']} != {r['kv_bytes_reckoned']}")
    t0 = time.perf_counter()
    reset_counts()
    want = pdry.one_process_1m_logits(CTX_1M, TP_1M, device="cuda")
    one_counts = read_counts()
    torch.cuda.empty_cache()
    out = dict(ranks_s=ranks_s, one_process_s=time.perf_counter() - t0, kv_bytes=r["kv_bytes"],
               logits=_hold_logits(f"13d TP = {TP_1M} decode at {CTX_1M - 8} tokens", r["logits"][0], want[0], "int4"),
               counts=[{k: v for k, v in x.items() if not k.startswith("collective.")} for x in r["launches"]],
               collectives=[{k: v for k, v in x.items() if k.startswith("collective.")} for x in r["launches"]],
               one_process_counts=one_counts)
    log(f"  13d dryrun_1m_decode({TP_1M}) on the card: KV {r['kv_bytes'][0]} bytes a rank = reckoned "
        f"({sum(r['kv_bytes']) / 2**30:.3f} GiB in all); rank 0's launches {out['counts'][0]}, collectives "
        f"{out['collectives'][0]}; {ranks_s:.1f} s (4 ranks share the card: not a TP speed figure)")
    return out


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
        t0 = time.perf_counter()
        phase_kernels(rec)
        phase_kernels_w8a8kv4(rec)
        phase_kernels_tp(rec)
        phase_kernels_13(rec)
        t1 = time.perf_counter()
        phase_kernels_d64(rec)
        record["kernels"] = rec.results
        log(f"  phase 3: {time.perf_counter() - t0:.1f} s (head_dim 64: {time.perf_counter() - t1:.1f} s)")

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
            log(f"phase 13a: pipeline stages, {fmt} (PipelinedEngine, PP = {PP} on the one card)")
            t0 = time.perf_counter()
            record["pipeline_" + fmt] = phase_pipeline(params, cfg, duo, kv_quant)
            record["pipeline_" + fmt]["phase_s"] = time.perf_counter() - t0
            log(f"  13a {fmt}: {record['pipeline_' + fmt]['phase_s']:.1f} s")
            del params  # free this format's weights before the next one's are made
            torch.cuda.empty_cache()
        log("phase 8b: serving bench (evals/serving_bench.py, W8A8KV4, defaults, no warm-up pass)")
        t0 = time.perf_counter()
        record["serving_bench"] = phase_serving_bench()
        log(f"  serving bench phase: {time.perf_counter() - t0:.1f} s")
        log("phase 9: the eval stack (constructed-8b NIAH and LongBench, efficiency)")
        t0 = time.perf_counter()
        record["eval"] = phase_eval()
        record["eval"]["phase_s"] = time.perf_counter() - t0
        log(f"  phase 9: {record['eval']['phase_s']:.1f} s")
        log("phase 10: gate training (constructed-8b in W8A8; the accuracy loop)")
        t0 = time.perf_counter()
        record["train"] = phase_train()
        record["train"]["phase_s"] = time.perf_counter() - t0
        log(f"  phase 10: {record['train']['phase_s']:.1f} s")
        log("phase 11: Mixtral-8x7B's MoE MLP at the published width (8 of 32 layers), bf16 and W8A8KV4")
        t0 = time.perf_counter()
        record["mixtral"] = phase_mixtral()
        record["mixtral"]["phase_s"] = time.perf_counter() - t0
        log(f"  phase 11: {record['mixtral']['phase_s']:.1f} s")
        log("phase 12: tensor parallelism (parallel/; TP = 2 over gloo on the one card, TP = 1 over NCCL)")
        t0 = time.perf_counter()
        record["tp"] = phase_tp()
        record["tp"]["phase_s"] = time.perf_counter() - t0
        log(f"  phase 12: {record['tp']['phase_s']:.1f} s")
        log("phase 13: --pp NIAH (13b), gate-training layouts (13c), the 1M-token sharded decode (13d)")
        t0 = time.perf_counter()
        p13 = record["phase13"] = {}
        for key, fn in (("niah_pp", phase_niah_pp), ("train_layouts", phase_train_layouts), ("decode_1m", phase_1m)):
            t1 = time.perf_counter()
            p13[key] = fn()
            p13[key]["phase_s"] = time.perf_counter() - t1
            log(f"  13 {key}: {p13[key]['phase_s']:.1f} s")
        p13["phase_s"] = time.perf_counter() - t0 + sum(record["pipeline_" + f]["phase_s"] for f, _, _ in formats)
        log(f"  phase 13: {p13['phase_s']:.1f} s (13a included)")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    runs = {fmt: record["end_to_end_" + fmt]["counts"] for fmt, _, _ in formats}
    runs.update({"serving_" + fmt: record["serving_" + fmt]["counts"] for fmt, _, _ in formats})
    runs.update({"eval_" + key: record["eval"][key]["counts"] for key in ("niah", "longbench", "efficiency")})
    runs["train_8b"] = record["train"]["train_8b"]["counts"]
    for fmt, _, _ in formats:
        runs["mixtral_" + fmt] = record["mixtral"][fmt]["end_to_end"]["counts"]
        runs["mixtral_serving_" + fmt] = record["mixtral"][fmt]["serving"]["counts"]
    for fmt in ("bf16", "w8a8kv4"):  # phase 12: each rank's run, and 12b's
        for x in record["tp"]["tp2_" + fmt]["ranks"]:
            runs[f"tp2_{fmt}_rank{x['rank']}"] = x["counts"]
            if "serving" in x:
                runs[f"tp2_serving_rank{x['rank']}"] = x["serving"]["counts"]
    for i, counts in enumerate(record["tp"]["tp2_mixtral"]["counts"]):
        runs[f"tp2_mixtral_rank{i}"] = counts
    # phase 13: 13a's pipelines, 13c's ranks, 13d's ranks and its one-process step
    runs.update({"pipeline_" + fmt: record["pipeline_" + fmt]["counts"] for fmt, _, _ in formats})
    runs.update(_train13_counts(record["phase13"]["train_layouts"]))
    for i, counts in enumerate(record["phase13"]["decode_1m"]["counts"]):
        runs[f"decode_1m_rank{i}"] = counts
    runs["decode_1m_one_process"] = record["phase13"]["decode_1m"]["one_process_counts"]
    # 10b and 13b are the paths at head_dim 64: their launches are the .d64 rows' (every other path is at 128)
    runs_d64 = {"accuracy_loop": record["train"]["accuracy_loop"]["counts"],
                "niah_pp": record["phase13"]["niah_pp"]["counts"]}
    line = []
    for name, cases in rec.results.items():
        if name not in REPLACES:
            continue
        head = next(c for c in cases if c["main"])  # the main path's shape
        d64 = name.endswith(".d64")
        paths = runs_d64 if d64 else ({**runs, **runs_d64} if name.startswith("w8a8") else runs)  # int8: any D
        launches = {fmt: counts.get(name.removesuffix(".d64"), 0) for fmt, counts in paths.items()}
        require(sum(launches.values()) > 0, f"{name}: no launch on either main path")
        line.append(dict(
            name=name, route="cuda",
            source="duo_attention_tpu_torch/csrc/" + SOURCES[name.split(".")[0]], head_dim=64 if d64 else 128,
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
