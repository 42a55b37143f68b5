"""Closed-loop serving of a configuration in its deployment ``format``.

The configuration's ``format`` says how the program holds the model: its
weights (``bfloat16``, or ``w8a8``: every decoder projection int8 per output
channel, int8 activations per token), its embedding and head (``int8`` and
``w8a8`` with W8A8 weights, else ``bfloat16``), its full heads' cache
(``int4`` or ``bfloat16``) and its streaming heads' cache (``bfloat16``).
The program gets the weights of ``core/weights.py`` quantized by its own
``ops/quant.py`` (``quantize_layer_weights`` a layer at a time as it is
drawn, so no whole bf16 copy is ever held, then
``quantize_embeddings_int8``) and a ``ServingEngine`` with
``kv_quant="int4"`` for an INT4 cache. The traffic, clock and sample are
``closed_loop``'s (``core/serve.py``); the sample is scored against the
format's plain reference (``reference/w8a8kv4.py``).

``run_formatted`` repeats ``core/serve.py::run_serving``, which builds the
bf16 program, around that build: the same set-up, warm phase, window,
traced span and sample.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from port_bench.core import counts, counts_quant, serve, trace
from port_bench.core.harness import Context, Outcome, log
from port_bench.core.timeline import serving_metrics
from port_bench.core.traffic import buckets
from port_bench.core.weights import Shape, make_layer, make_top

# each part of a format and the one quantized form the program has for it
QUANTIZED = {"weights": "w8a8", "embedding": "int8", "lm_head": "w8a8", "kv_cache_full_heads": "int4",
             "kv_cache_streaming_heads": None}


def format_flags(fmt: dict):
    """(W8A8 weights, embedding and head; an INT4 full-head cache) of a
    format; raises on one the program or the reference does not have."""
    for part, quantized in QUANTIZED.items():
        if fmt[part] not in ("bfloat16", quantized):
            raise ValueError(f"format: {part} {fmt[part]!r} (the program has bfloat16 or {quantized})")
    w8a8 = {fmt[p] != "bfloat16" for p in ("weights", "embedding", "lm_head")}
    if len(w8a8) != 1:
        raise ValueError(f"format {fmt}: the weights, embedding and head are quantized together or not at all")
    return w8a8.pop(), fmt["kv_cache_full_heads"] == "int4"


def formatted_params(ctx: Context, w8a8: bool) -> dict:
    """The seed's weights in the program's params layout (natural head
    order), each layer quantized as it is drawn."""
    from duo_attention_tpu_torch.ops.quant import quantize_embeddings_int8, quantize_layer_weights

    shape = Shape.of(ctx.conf)
    quant = quantize_layer_weights if w8a8 else (lambda layer: layer)
    params = make_top(shape, ctx.seed, ctx.device)
    if w8a8:
        params = quantize_embeddings_int8(params)
    params["layers"] = [quant(make_layer(shape, ctx.seed, li, ctx.device)) for li in range(shape.layers)]
    return params


# the references a compared number reads: the format's, and the format's with one half left out
VARIANTS = {"format": {}, "without_kv4": {"kv_bits": None}, "without_w8a8": {"weight_bits": None}}
# each compared number: the served tokens' mean gap in the format's reference, over (for a ratio) their
# mean gap in the reference named second
CHECKS = {"served_mean_gap": ("format", None), "served_kv4_gap_ratio": ("format", "without_kv4"),
          "served_w8a8_gap_ratio": ("format", "without_w8a8")}


def reference_logits(ctx: Context, served, variant: str = "format", **lower):
    """The reference's logits at the served positions, in the precision of
    the configuration's format, with ``VARIANTS[variant]`` left out and
    ``lower`` (``reference/w8a8kv4.py``'s bits) set."""
    from port_bench.reference.w8a8kv4 import logits_at

    t0 = time.monotonic()
    w8a8, kv4 = format_flags(ctx.conf["format"])
    bits = {"weight_bits": 8 if w8a8 else None, "kv_bits": 4 if kv4 else None, **VARIANTS[variant], **lower}
    logits = logits_at(ctx.conf, ctx.seed, served, ctx.device, **bits)
    log(f"reference {bits}: {len(served)} requests, {sum(len(t) for _, t in served)} served tokens, "
        f"prompts {[len(p) for p, _ in served]}, {time.monotonic() - t0:.3f} s")
    return logits


def mean_gap(logits, tokens) -> float:
    """The mean over the served tokens of how far each one's logit lies
    below the best logit at its position."""
    from port_bench.reference.model import gaps

    return float(np.concatenate([gaps(lg, t) for lg, t in zip(logits, tokens)]).mean())


def compared(logits: dict, tokens, names=tuple(CHECKS)) -> dict:
    """The numbers ``names`` (``CHECKS``) of the tokens ``tokens`` (one list a
    request) against the references' logits ``logits`` (by ``VARIANTS``
    name)."""
    out = {}
    for name in names:
        over, under = CHECKS[name]
        value = mean_gap(logits[over], tokens)
        out[name] = value / mean_gap(logits[under], tokens) if under else value
    return out


def formatted_checks(ctx: Context, served) -> list:
    """The numbers compared: ``served_mean_gap``, the served tokens' mean gap
    in the format's reference, and two ratios of it, over their mean gap in
    the same reference without its INT4 cache (``served_kv4_gap_ratio``) and
    without its W8A8 (``served_w8a8_gap_ratio``): under 1 where the tokens
    carry that half's roundings, over 1 where they were served without it.
    NaN without a sample."""
    if not served:
        return [(name, float("nan"), limit) for name, limit in ctx.limits.items()]
    needed = {v for name in ctx.limits for v in CHECKS[name] if v}
    logits = {v: reference_logits(ctx, served, v) for v in sorted(needed)}
    values = compared(logits, [toks for _, toks in served], ctx.limits)
    checks = [(name, values[name], limit) for name, limit in ctx.limits.items()]
    log("compared: " + ", ".join(f"{n} {v!r} (limit {lim!r})" for n, v, lim in checks))
    return checks


def run_formatted(ctx: Context, check: bool = True, program_format: dict = None) -> Outcome:
    """One serving run of the program in the configuration's format (or in
    ``program_format``, scored all the same against the configuration's).
    The sample is handed back in ``notes["served"]``; with ``check=False``
    it is not scored."""
    import torch

    from duo_attention_tpu_torch.serving import ServingEngine

    mix, conf, dev = ctx.mix, ctx.conf, ctx.device
    w8a8, kv4 = format_flags(program_format or conf["format"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)  # the allocator exists before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    t_imported = time.monotonic()
    params, cfg, duo = serve.build_program(ctx, formatted_params(ctx, w8a8))
    t_weights = time.monotonic()
    eng = ServingEngine(params, cfg, duo, max_batch_size=mix["slots"], decode_burst=mix["decode_burst"],
                        kv_quant="int4" if kv4 else "none", device=dev, timing=ctx.trace)
    loop = serve.Loop(ctx, eng, closed=True)
    if kv4:  # the log's KV held: full heads at the INT4 cache's bytes
        model = counts.Model.of(conf)
        loop.kv_full = sum(model.full) * counts_quant.q4_bytes_per_token(model)
    t_build = time.monotonic()
    if cuda:
        lo = mix["prompt"]["min"] + 1
        hi = mix["prompt"]["max"] + mix["output"]["max"] + mix["decode_burst"]
        for b in buckets(lo, hi, duo.max_cache_size):
            eng.pool_graph(b, False)
        torch.cuda.synchronize(dev)
    t_graphs = time.monotonic()

    # warm phase: the traffic itself, until every client has had a request admitted
    loop.t0 = time.monotonic()
    for _ in range(mix["clients"]):
        loop.submit(time.monotonic())
    first = list(loop.lines)
    while any(loop.lines[k].first_token() is None for k in first):
        loop.iterate()
    if cuda:
        torch.cuda.synchronize(dev)
    w0 = time.monotonic()
    setup_s = w0 - ctx.t_start
    log(f"set-up {setup_s:.3f} s: start and imports {t_imported - ctx.t_start:.3f}, weights {t_weights - t_imported:.3f}, "
        f"engine {t_build - t_weights:.3f}, graphs {t_graphs - t_build:.3f}, "
        f"warm phase {w0 - loop.t0:.3f} ({loop.next} requests submitted)")

    # the window
    traced = None
    if ctx.trace:
        from torch.profiler import record_function

        from port_bench.core.profile import device_breakdown

        def span():
            for _ in range(mix["trace_iterations"]):
                with record_function(trace.STEP):
                    loop.iterate(record=True)

        t_prof = time.monotonic()
        frozen = device_breakdown(span)
        traced = trace.reduce(frozen.pop("events"), frozen["wall_ms"])
        log(trace.summary(traced) + f"\n  profiling and reading the span took {time.monotonic() - t_prof:.3f} s; "
            f"the frozen breakdown's idle share {frozen['idle_share']} (it counts the benchmark's ranges as device work)")
    held = [0.0, 0.0, 0.0]  # seconds, live-row seconds and KV-byte seconds of the untraced window
    while time.monotonic() < w0 + ctx.seconds:
        t, rows, kv = time.monotonic(), sum(r is not None for r in eng.slots), loop.kv_held()
        loop.iterate()
        dt = time.monotonic() - t
        held = [held[0] + dt, held[1] + rows * dt, held[2] + kv * dt]
    if cuda:
        torch.cuda.synchronize(dev)
    w1 = time.monotonic()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    e2e = serving_metrics(loop.lines, w0, w1)
    e2e["setup_s"] = setup_s
    attempted = sum(1 for tl in loop.lines.values() if w0 <= tl.due < w1)
    finished = sum(1 for k, r in loop.reqs.items() if r.done and w0 <= loop.lines[k].seen[-1][0] <= w1)
    notes = {"finished_in_window": finished, "open_at_close": len(loop.open), "generator_late_s": loop.lateness}
    log(f"window {w1 - w0:.3f} s: {attempted} requests due, {e2e['ttft_samples']} ttft samples, "
        f"{e2e['tpot_samples']} tpot samples, {sum(r.done for r in loop.reqs.values())} finished in all, "
        f"{len(loop.open)} open at the close, generator late by at most {loop.lateness * 1e3:.1f} ms; memory peak {peak / 1e9:.3f} GB, of it KV buffers "
        f"{sum(t.numel() * t.element_size() for n in eng.cache.BUFFERS for t in getattr(eng.cache, n)) / 1e9:.3f} GB")
    log("end to end, every metric of the traffic: " + ", ".join(f"{k} {v!r}" for k, v in e2e.items()))
    if held[0] > 0:
        log(f"untraced part of the window: {held[1] / held[0]:.3f} live rows and "
            f"{held[2] / held[0] / 1e9:.3f} GB of KV held by them on average, of {mix['slots']} slots reserved")

    record = None
    if ctx.trace:
        record = {"trace": traced, "iters": loop.iters, "model": counts.Model.of(conf), "conf": conf,
                  "ttft_p90_ms": e2e.get("ttft_p90_ms")}
    sample = serve.choose_sample(loop, ctx)
    served = [(np.asarray(loop.reqs[k].prompt_ids), list(loop.reqs[k].generated)) for k in sample]
    del eng, params, loop.eng
    loop.reqs = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    notes["served"] = served
    out = Outcome(e2e=e2e, checks=formatted_checks(ctx, served) if check else [],
                  attempted=attempted, failed=0, memory_peak_bytes=peak, record=record, notes=notes)
    if traced is not None:
        out.busy_s, out.window_s, out.breakdown = traced["busy_s"], traced["window_s"], trace.breakdown(traced)
    return out


def run(ctx):
    return run_formatted(ctx)
