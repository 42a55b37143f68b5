"""The formatted serving cell (``drivers/closed_loop_formatted.py``) at tiny
sizes on the CPU's plain paths: it runs and reads correct; a served token
altered, the program over a bf16 cache or with bf16 weights under the
W8A8KV4 format, or the reference computed below the format, reads not
correct; the program gets the format's weights; the INT4 and W8A8 counts
match the program's buffers; each new reader reads a share in (0, 100] of a
synthetic record; and the new files import neither JAX nor, in the
reference, the program."""

from pathlib import Path

import pytest
import torch

from port_bench.core import counts, counts_quant, harness
from port_bench.core.harness import BENCH_DIR, check_ok, load_module
from port_bench.core.profile import PEAK_BYTES, PEAK_INT8_OPS
from port_bench.tests.test_port_bench_imports import JAX, imported

W8A8KV4 = {"weights": "w8a8", "embedding": "int8", "lm_head": "w8a8", "kv_cache_full_heads": "int4",
           "kv_cache_streaming_heads": "bfloat16"}
MIX = {"driver": "closed_loop_formatted", "clients": 3, "slots": 2, "decode_burst": 4,
       "prompt": {"dist": "loguniform", "min": 40, "max": 200}, "output": {"dist": "uniform", "min": 8, "max": 24},
       "trace_iterations": 3, "check": {"served_tokens": 150, "max_requests": 8}}
# the cell's own limits, which the tiny cell is held to
LIMITS = harness.load_json(BENCH_DIR / "configs" / "mistral-7b-v0.2-w8a8kv4.json")["limits"]
NEW_FILES = ("reference/w8a8kv4.py", "core/counts_quant.py", "drivers/closed_loop_formatted.py",
             "control_quantized.py", "metrics/kernels.attn_decode_q4_roofline.py",
             "metrics/kernels.attn_prefill_q4_roofline.py", "metrics/kernels.w8a8_decode_roofline.py",
             "metrics/kernels.w8a8_prefill_roofline.py", "metrics/engine.prefill_quant_share.py")
READERS = ("kernels.attn_decode_q4_roofline", "kernels.attn_prefill_q4_roofline", "kernels.w8a8_decode_roofline",
           "kernels.w8a8_prefill_roofline", "engine.prefill_quant_share")


def driver():
    return load_module("drivers", "closed_loop_formatted")


@pytest.fixture
def formatted(cpu_context):
    def make(seconds: float = 2.0):
        ctx = cpu_context("closed", seconds=seconds)
        ctx.conf["format"] = dict(W8A8KV4)
        ctx.mix = dict(MIX)
        ctx.limits = dict(LIMITS)
        return ctx

    return make


def correct(outcome):
    return bool(outcome.checks) and all(check_ok(v, lim) for _, v, lim in outcome.checks) and outcome.attempted > 0


def test_the_formatted_driver_runs(formatted):
    out = driver().run(formatted())
    assert correct(out), out.checks
    assert [n for n, _, _ in out.checks] == list(LIMITS)
    assert out.e2e["setup_s"] > 0 and out.e2e["output_tokens_per_s"] > 0 and out.e2e["tpot_samples"] > 0


def test_a_token_altered_reads_not_correct(formatted, monkeypatch):
    from duo_attention_tpu_torch import serving

    real = serving._batched_decode_step
    monkeypatch.setattr(serving, "_batched_decode_step", lambda *a, **k: torch.remainder(real(*a, **k) + 1, 512))
    assert not correct(driver().run(formatted()))


BF16_WEIGHTS = {"weights": "bfloat16", "embedding": "bfloat16", "lm_head": "bfloat16"}


@pytest.mark.parametrize("left_out, part, ratio", [
    ("kv4", {"kv_cache_full_heads": "bfloat16"}, "served_kv4_gap_ratio"),
    ("w8a8 and kv4", {"kv_cache_full_heads": "bfloat16", **BF16_WEIGHTS}, "served_kv4_gap_ratio"),
    ("w8a8", BF16_WEIGHTS, "served_w8a8_gap_ratio"),
])
def test_a_program_without_a_half_of_the_format_reads_not_correct(formatted, left_out, part, ratio):
    """The controls at the tiny size: the program's ``served_kv4_gap_ratio``
    read 0.37-0.62 (6 seeds of ~110-160 served tokens), over a bf16 cache
    2.1-13.4, the bf16 program 2.1-6.5; its ``served_w8a8_gap_ratio`` read
    0.60-0.81 (3 seeds), with bf16 weights over the INT4 cache 3.4-4.3."""
    out = driver().run_formatted(formatted(), program_format=dict(W8A8KV4, **part))
    assert not correct(out), out.checks
    assert dict((n, v) for n, v, _ in out.checks)[ratio] > LIMITS[ratio]


@pytest.mark.parametrize("lower", ["w4a8kv4", "w8a8kv2"])
def test_the_reference_below_the_format_reads_not_correct(formatted, lower):
    """The reference's own choices in a lower precision, teacher-forced on
    the served sample (``control_quantized.py``), fail the mean gap. At the
    tiny size (3 seeds) they read 0.34-0.44 (INT4 weights) and 0.26-0.34
    (a 2-bit full-head cache), the program 0.0075-0.0095."""
    from port_bench.control_quantized import LOWER_CONTROLS

    ctx = formatted()
    d = driver()
    served = d.run_formatted(ctx, check=False).notes["served"]
    logits = {v: d.reference_logits(ctx, served, v) for v in d.VARIANTS}
    chosen = [lg.argmax(dim=-1).tolist() for lg in d.reference_logits(ctx, served, **LOWER_CONTROLS[lower])]
    values = d.compared(logits, chosen)
    assert not all(check_ok(values[name], limit) for name, limit in LIMITS.items()), values
    assert values["served_mean_gap"] > LIMITS["served_mean_gap"]
    assert d.compared(logits, [t for _, t in served])["served_mean_gap"] <= LIMITS["served_mean_gap"]


def test_the_program_gets_the_formats_weights(formatted):
    """Quantized as drawn, a layer at a time: bitwise the program's own
    quantization of the whole bf16 draw."""
    from duo_attention_tpu_torch.ops.quant import quantize_embeddings_int8, quantize_params_w8a8
    from port_bench.core.weights import Shape, make_params

    ctx = formatted()
    got = driver().formatted_params(ctx, w8a8=True)
    want = quantize_embeddings_int8(quantize_params_w8a8(make_params(Shape.of(ctx.conf), ctx.seed, "cpu")))
    assert sorted(got) == sorted(want) and "embed_q8" in got and "wq_q8" in got["layers"][0]
    for a, b in zip(got["layers"], want["layers"]):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(got[k], want[k]) for k in got if k != "layers")
    assert driver().format_flags(W8A8KV4) == (True, True)
    with pytest.raises(ValueError):
        driver().format_flags(dict(W8A8KV4, lm_head="bfloat16"))
    with pytest.raises(ValueError):
        driver().format_flags(dict(W8A8KV4, kv_cache_streaming_heads="int4"))


def test_the_counts_match_the_programs_buffers(formatted):
    """INT4 bytes a full head a position as the pool allocates them; the
    weight bytes a decode step reads as the quantized params hold them."""
    from duo_attention_tpu_torch.cache import init_cache_q4
    from port_bench.core.serve import build_program

    ctx = formatted()
    params, cfg, duo = build_program(ctx, driver().formatted_params(ctx, w8a8=True))
    model = counts.Model.of(ctx.conf)
    cache = init_cache_q4(cfg, duo, 1, torch.bfloat16, "cpu", decode_only=True)
    full = sum(t.numel() * t.element_size() for name in cache.BUFFERS if "full" in name for t in getattr(cache, name))
    assert full == counts_quant.q4_bytes_per_token(model) * sum(model.full) * duo.max_cache_size
    held = sum(t.numel() * t.element_size() for layer in params["layers"] for k, t in layer.items()
               if k.endswith(("_q8", "_scale")))
    held += params["lm_head_q8"].numel() + 4 * params["lm_head_scale"].numel()
    assert counts_quant.projection_weight_bytes(model) == held
    assert counts_quant.prefill_projection_ops(model, 10) == 2.0 * model.layer_params() * model.shape.layers * 10
    assert counts_quant.decode_attn_q4_bytes(model, [0, 9]) == sum(model.full) * (
        counts_quant.q4_bytes_per_token(model) * 11 + 2 * 2 * model.shape.groups * model.shape.head_dim * 2)


def synthetic_record(conf: dict, share: float) -> dict:
    """One traced iteration (a 4,096-token chunk from 8,192, then 16 decode
    steps of three rows) whose kernels each took 100 / ``share`` times their
    bound."""
    model = counts.Model.of(conf)
    chunk = {"start": 8192, "tokens": 4096, "seconds": 0.5}
    burst = {"steps": 16, "lengths": [5000, 9000, 20000], "seconds": 0.2, "live": 3}
    record = {"model": model, "iters": [{"admit": chunk, "decode": burst}]}
    steps = [[n + t for n in burst["lengths"]] for t in range(16)]
    us = {"full_cache_attention_q4.prefill": counts.prefill_attn_flops(model, 8192, 4096) / 989e12,
          "w8a8_matmul.tiled": counts_quant.prefill_projection_ops(model, 4096) / PEAK_INT8_OPS,
          "full_cache_attention_q4.decode": sum(counts_quant.decode_attn_q4_bytes(model, ls) for ls in steps) / PEAK_BYTES,
          "decode w8a8_matmul.tiled": 16 * counts_quant.projection_weight_bytes(model) / PEAK_BYTES}
    us = {k: v * 1e6 * 100.0 / share for k, v in us.items()}
    device, at = [], 10.0
    for name in ("full_cache_attention_q4.prefill", "w8a8_matmul.tiled"):
        device.append((name, name, at, at + us[name]))
        at += us[name] + 5
    graph0 = at
    for name in ("full_cache_attention_q4.decode", "decode w8a8_matmul.tiled"):
        device.append((name, name.split()[-1], at + 5, at + 5 + us[name]))
        at += us[name] + 10
    record["trace"] = {"device": device, "host": [], "steps": [{"s0": 0.0, "s1": at + 10, "graph0": graph0}],
                       "t0": 0.0, "t1": at + 10, "busy_s": 0.0, "window_s": (at + 10) / 1e6}
    return record


@pytest.mark.parametrize("name", READERS)
def test_a_new_reader_reads_a_share(name, monkeypatch):
    from duo_attention_tpu_torch import tracing

    conf = harness.load_json(BENCH_DIR / "configs" / "mistral-7b-v0.2-w8a8kv4.json")
    chunk = tracing.Span("engine.prefill_chunk", counts={"tokens": 4096})
    quant = [tracing.Span("engine.quantize_act") for _ in range(4)]
    stray = tracing.Span("engine.quantize_act")  # in a decode burst's warm-up step: not prefill
    chunk.device_ms, chunk.session, chunk.t1 = 400.0, 3, 1
    for q in quant:
        q.parent, q.device_ms, q.session, q.t1 = chunk.id, 25.0, 3, 1
    stray.device_ms, stray.session, stray.t1 = 99.0, 3, 1
    monkeypatch.setattr(tracing, "spans", lambda: [chunk, *quant, stray])
    read = load_module("metrics", name).read
    value = read(synthetic_record(conf, 40.0))
    assert 0 < value <= 100
    assert value == pytest.approx(25.0 if name == "engine.prefill_quant_share" else 40.0, rel=1e-9)
    monkeypatch.setattr(tracing, "spans", lambda: [chunk])  # a program without the span
    assert read(None) is None and (name != "engine.prefill_quant_share" or read({}) is None)


@pytest.mark.parametrize("path", NEW_FILES)
def test_the_new_files_import_no_jax(path):
    names = imported(BENCH_DIR / path)
    assert not names & JAX
    if path.startswith("reference/"):
        assert "duo_attention_tpu_torch" not in names


def test_the_cell_names_its_files():
    bench = harness.load_json(Path(BENCH_DIR).parent / "BENCHMARK.json")
    cell = harness.find_cell(bench, "mistral-7b-v0.2-w8a8kv4.longdoc")
    mix = harness.load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    longdoc = harness.load_json(BENCH_DIR / "traffic" / "longdoc.json")
    assert mix == dict(longdoc, driver="closed_loop_formatted")
    conf = harness.load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    bf16 = harness.load_json(BENCH_DIR / "configs" / "mistral-7b-v0.2.json")
    own = ("name", "deployment", "assumed", "format", "limits")  # what a configuration says of itself
    assert {k: v for k, v in conf.items() if k not in own} == {k: v for k, v in bf16.items() if k not in own}
    assert conf["reduced"] == {}
    assert driver().format_flags(conf["format"]) == (True, True)
    assert {m["name"] for m in harness.cell_metrics(bench, cell, True)} >= set(READERS)
    assert harness.find_limits(conf, cell["name"]) == LIMITS
    assert set(LIMITS) == {"served_mean_gap", "served_kv4_gap_ratio", "served_w8a8_gap_ratio"}
