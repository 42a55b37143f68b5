"""The per-layer readers of the program's spans (``core/spans.py`` and the
nine metrics that read it): None without the program's recorder or with
no spans; the expected value on a synthetic span list and reduced trace
(an idle gap half inside an admission chunk, the program's clock a few
hundred us off the profile's); and the program's bf16 full-head K/V bytes
of a burst equal to the K/V part of ``counts.decode_attn_bytes``."""

import sys

import numpy as np
import pytest
import torch

from port_bench.core import counts, harness
from port_bench.core.harness import BENCH_DIR

NEW = ("engine.decode_step_device_ms", "engine.prefill_device_ms_per_ktok", "kernels.attn_decode_dead_share",
       "serving.kv_live_share", "train.backward_share", "device.idle_in_admit", "device.idle_in_decode",
       "device.idle_in_forward", "device.idle_in_backward")
SESSION = 7
OFFSET_US = 350.0  # the program's clock stands this far after the profile's


def reader(name):
    return harness.load_module("metrics", name, BENCH_DIR).read


def span(name, t0_us, t1_us, parent=None, device_ms=None, session=SESSION, **counts):
    """A closed span at t0..t1 us of the profile's timeline, in the program's ns."""
    from duo_attention_tpu_torch import tracing

    sp = tracing.Span(name, counts=counts)
    sp.t0, sp.t1 = int((t0_us + OFFSET_US) * 1e3), int((t1_us + OFFSET_US) * 1e3)
    sp.parent, sp.device_ms, sp.session = parent, device_ms, session
    return sp


def reduced(gaps, t1=10_000.0):
    """A reduced trace from 0 to t1 us, busy but for ``gaps``, with the
    program's clock range at 40-42 us."""
    device, at = [], 0.0
    for a, b in gaps:
        device.append(("k", "other", at, a))
        at = b
    device.append(("k", "other", at, t1))
    busy = sum(e - s for _, _, s, e in device)
    return {"device": device, "host": [("bench.step", 0.0, t1), ("duo.trace.clock", 40.0, 42.0)], "t0": 0.0,
            "t1": t1, "steps": [], "busy_s": busy / 1e6, "window_s": t1 / 1e6}


@pytest.fixture
def program(monkeypatch):
    """Hands the readers a span list in place of the recorder's, with the
    session's anchor stamped OFFSET_US after the profile's clock range."""
    from duo_attention_tpu_torch import tracing

    def use(spans):
        monkeypatch.setattr(tracing, "spans", lambda: list(spans))
        monkeypatch.setitem(tracing._anchors, SESSION, (int((40.0 + OFFSET_US) * 1e3), int((42.0 + OFFSET_US) * 1e3)))

    return use


def serving_spans():
    step1, step2 = span("serve.step", 1000, 3000), span("serve.step", 5000, 8000)
    step1.id, step2.id = 1, 2
    return [
        step1, span("serve.admit", 1100, 2000, parent=1),
        span("engine.prefill_chunk", 1150, 1950, parent=3, device_ms=0.6, tokens=300),
        span("serve.decode", 2000, 2900, parent=1, device_ms=0.8, steps=4, kv_live_bytes=100, kv_pool_bytes=1000,
             attn_full_live_bytes=30, attn_full_dead_bytes=10),
        step2,
        span("serve.admit", 5050, 5950, parent=2),
        span("engine.prefill_chunk", 5100, 5900, parent=6, device_ms=0.9, tokens=100),
        span("serve.decode", 6000, 7900, parent=2, device_ms=1.6, steps=12, kv_live_bytes=300, kv_pool_bytes=1000,
             attn_full_live_bytes=50, attn_full_dead_bytes=110),
    ]


def train_spans():
    step = span("train.step", 500, 9000)
    step.id = 11
    return [step, span("train.forward", 600, 3000, parent=11, device_ms=3.0),
            span("train.backward", 3000, 8000, parent=11, device_ms=4.5),
            span("train.update", 8000, 8900, parent=11, device_ms=0.5)]


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_recorder(name, monkeypatch):
    import duo_attention_tpu_torch

    monkeypatch.setitem(sys.modules, "duo_attention_tpu_torch.tracing", None)  # a program without it
    monkeypatch.delattr(duo_attention_tpu_torch, "tracing", raising=False)
    with pytest.raises(ImportError):
        from duo_attention_tpu_torch import tracing  # noqa: F401
    assert reader(name)({"trace": reduced([(100.0, 200.0)])}) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(name, program):
    program([])
    assert reader(name)({"trace": reduced([(100.0, 200.0)])}) is None
    program([span("serve.step", 0, 100, session=None)])  # recorded outside a profiler: not read
    assert reader(name)({"trace": reduced([(100.0, 200.0)])}) is None


def test_serving_readers_on_synthetic_spans(program):
    program(serving_spans())
    # gaps: 1500-2500 half in the first admission and half in the first burst, 2950-3500 mostly between
    # the program's phases, 4000-4500 outside every span, 6000-6200 inside the second burst
    rec = {"trace": reduced([(1500.0, 2500.0), (2950.0, 3500.0), (4000.0, 4500.0), (6000.0, 6200.0)])}
    assert reader("engine.decode_step_device_ms")(rec) == pytest.approx((0.8 + 1.6) / 16)
    assert reader("engine.prefill_device_ms_per_ktok")(rec) == pytest.approx(1e3 * 1.5 / 400)
    assert reader("kernels.attn_decode_dead_share")(rec) == pytest.approx(100 * 120 / 200)
    assert reader("serving.kv_live_share")(rec) == pytest.approx(100 * (100 * 4 + 300 * 12) / (1000 * 16))
    admit, decode = reader("device.idle_in_admit")(rec), reader("device.idle_in_decode")(rec)
    assert admit == pytest.approx(100 * (2000 - 1500) / 10_000)
    assert decode == pytest.approx(100 * ((2500 - 2000) + (6200 - 6000)) / 10_000)
    share = reader("device.idle_share.serve")(rec)
    assert share == pytest.approx(100 * 2250 / 10_000) and admit + decode < share
    assert reader("train.backward_share")(rec) is None
    assert reader("device.idle_in_forward")(rec) == reader("device.idle_in_backward")(rec) == 0.0


def test_training_readers_on_synthetic_spans(program):
    program(train_spans())
    rec = {"trace": reduced([(200.0, 700.0), (2900.0, 3100.0), (8950.0, 9500.0)])}
    assert reader("train.backward_share")(rec) == pytest.approx(100 * 4.5 / 8.0)
    assert reader("device.idle_in_forward")(rec) == pytest.approx(100 * ((700 - 600) + (3000 - 2900)) / 10_000)
    assert reader("device.idle_in_backward")(rec) == pytest.approx(100 * (3100 - 3000) / 10_000)
    assert reader("engine.decode_step_device_ms")(rec) is None


def test_idle_reads_zero_in_a_phase_the_span_did_not_run(program):
    """A traced span with scheduler iterations but no admission: idle in
    admission reads 0, not nothing."""
    program([s for s in serving_spans() if s.name != "serve.admit"])
    assert reader("device.idle_in_admit")({"trace": reduced([(1500.0, 2500.0)])}) == 0.0


def test_idle_needs_the_clock_range(program):
    program(serving_spans())
    rec = {"trace": reduced([(2500.0, 3500.0)])}
    rec["trace"]["host"] = rec["trace"]["host"][:1]
    assert reader("device.idle_in_decode")(rec) is None and reader("device.idle_in_admit")(rec) is None
    assert reader("engine.decode_step_device_ms")(rec) is not None  # device times need no alignment


def test_only_the_last_profiler_session_is_read(program):
    old = span("serve.decode", 0, 10, device_ms=50.0, session=SESSION - 1, steps=1, kv_live_bytes=1,
               kv_pool_bytes=1, attn_full_live_bytes=1, attn_full_dead_bytes=0)
    program([old] + serving_spans())
    assert reader("engine.decode_step_device_ms")({}) == pytest.approx((0.8 + 1.6) / 16)


def test_bf16_live_reads_equal_the_counts(cpu_context):
    """A bf16 pool's ``attn_full_live_bytes`` for live rows at given lengths
    equals the K/V part of ``counts.decode_attn_bytes`` (q and out left
    out) summed over the burst's steps, and a freed row adds its stale
    length a step to the dead bytes alone."""
    from duo_attention_tpu_torch.serving import Request, ServingEngine

    from port_bench.core.serve import build_program

    ctx = cpu_context("closed")
    params, cfg, duo = build_program(ctx)
    eng = ServingEngine(params, cfg, duo, max_batch_size=4, device="cpu")
    assert eng.cache.k_full[0].dtype == torch.bfloat16
    lengths, steps, bucket = {0: 97, 2: 301}, 5, 512
    for slot, n in lengths.items():
        eng.slots[slot] = Request(rid=slot, prompt_ids=np.zeros(n, np.int32), max_new_tokens=8)
        eng.lengths[slot] = n
    eng.stale[1] = 700  # a freed row past the bucket
    got = eng._burst_counts(steps, bucket)
    m = counts.Model.of(ctx.conf)
    hf, D, G = sum(m.full), m.shape.head_dim, m.shape.groups
    kv = sum(counts.decode_attn_bytes(m, [n + t for n in lengths.values()]) - hf * D * counts.BF16 * 2 * G * 2
             for t in range(steps))
    assert got["attn_full_live_bytes"] == kv
    assert got["attn_full_dead_bytes"] == steps * bucket * hf * D * 2 * counts.BF16
    assert got["rids"] == [0, 2]
