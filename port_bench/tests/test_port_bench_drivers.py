"""Each driver runs on the CPU at tiny sizes through the port's plain paths;
the reference agrees with the port; a broken timed path reads not correct."""

import numpy as np
import pytest
import torch

from port_bench.core.harness import check_ok, load_module


def correct(outcome):
    return all(check_ok(v, lim) for _, v, lim in outcome.checks) and outcome.attempted > 0


@pytest.mark.parametrize("moe", [False, True], ids=["tiny-gqa", "tiny-moe"])
@pytest.mark.parametrize("mix", ["closed", "open"])
def test_serving_driver_runs(cpu_context, mix, moe):
    ctx = cpu_context(mix, moe)
    out = load_module("drivers", ctx.mix["driver"]).run(ctx)
    assert correct(out), out.checks
    assert out.e2e["setup_s"] > 0 and out.e2e["output_tokens_per_s"] > 0
    assert "ttft_p90_ms" in out.e2e and out.attempted > 0


@pytest.mark.parametrize("mix", ["closed", "open"])
def test_a_traced_run_keeps_its_ttft_for_the_reader(cpu_context, monkeypatch, mix):
    """``serving.ttft_p90_ms`` reads the traced run's own TTFT tail, the
    end-to-end arithmetic's, from its record; with no record, nothing. (The
    profiler's part needs the card: here it only runs the span.)"""
    from port_bench.core import profile, trace

    def span_only(fn):
        fn()
        return {"events": [], "wall_ms": 1.0, "idle_share": 0.0}

    monkeypatch.setattr(profile, "device_breakdown", span_only)
    monkeypatch.setattr(trace, "reduce", lambda events, wall_ms: {"busy_s": 0.0, "window_s": wall_ms / 1e3})
    monkeypatch.setattr(trace, "summary", lambda traced: "")
    monkeypatch.setattr(trace, "breakdown", lambda traced: {})
    ctx = cpu_context(mix)
    ctx.trace = True
    out = load_module("drivers", ctx.mix["driver"]).run(ctx)
    reader = load_module("metrics", "serving.ttft_p90_ms")
    assert reader.read(out.record) == out.e2e["ttft_p90_ms"] > 0
    assert reader.read(None) is None and reader.read({"iters": []}) is None


def test_gate_train_driver_runs(cpu_context):
    ctx = cpu_context("train", seconds=0.5)
    out = load_module("drivers", "gate_train").run(ctx)
    assert correct(out), out.checks
    assert out.e2e["train_tokens_per_s"] > 0 and out.attempted >= 1


@pytest.mark.parametrize("moe", [False, True], ids=["tiny-gqa", "tiny-moe"])
def test_reference_agrees_with_the_port(cpu_context, moe):
    """float32 weights through the port's plain chunked prefill and decode,
    against the reference's logits at the same positions."""
    from duo_attention_tpu_torch.engine import DuoEngine
    from duo_attention_tpu_torch.models import llama
    from port_bench.core.serve import build_program
    from port_bench.core.weights import Shape, make_params
    from port_bench.reference.model import logits_at

    ctx = cpu_context("closed", moe)
    shape = Shape.of(ctx.conf)
    params = make_params(shape, ctx.seed, "cpu")
    params = {k: ([{n: t.float() for n, t in l.items()} for l in v] if k == "layers" else v.float())
              for k, v in params.items()}
    params, cfg, duo = build_program(ctx, params)
    eng = DuoEngine(params, cfg, duo, batch_size=1, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(0).integers(0, shape.vocab, 150)
    served = list(np.random.default_rng(1).integers(0, shape.vocab, 12))
    with torch.no_grad():
        cache, logits = eng.prefill(prompt[None])
        got = [logits[0]]
        for t in served[:-1]:
            hidden, cache = llama.forward_chunk(params, cfg, duo, cache, torch.tensor([[t]]), 1,
                                                full_bucket=eng.bucket_for(int(cache.length) + 1), plain=True)
            got.append(llama.logits_at(params, hidden, 0, plain=True)[0])
    ref = logits_at(ctx.conf, ctx.seed, [(prompt, served)], "cpu")[0]
    assert torch.allclose(torch.stack(got), ref, atol=2e-4, rtol=1e-4), (torch.stack(got) - ref).abs().max()


def test_a_token_altered_reads_not_correct(cpu_context, monkeypatch):
    from duo_attention_tpu_torch import serving

    real = serving._batched_decode_step
    monkeypatch.setattr(serving, "_batched_decode_step",
                        lambda *a, **k: torch.remainder(real(*a, **k) + 1, 512))
    out = load_module("drivers", "closed_loop").run(cpu_context("closed"))
    assert not correct(out), out.checks


def test_a_step_that_keeps_its_state_reads_not_correct(cpu_context, monkeypatch):
    from duo_attention_tpu_torch import serving

    monkeypatch.setattr(serving, "_batched_decode_step", lambda params, cfg, duo, cache, tokens, *a, **k: tokens)
    out = load_module("drivers", "closed_loop").run(cpu_context("closed"))
    assert not correct(out), out.checks


def test_half_the_batch_left_out_reads_not_correct(cpu_context, monkeypatch):
    """The pool's second half of rows keeps its tokens: those requests repeat
    a token, and the sample (the longest and more, drawn from both halves of
    the pool) holds one."""
    from duo_attention_tpu_torch import serving

    real = serving._batched_decode_step

    def half(params, cfg, duo, cache, tokens, active, *a, **k):
        nxt = real(params, cfg, duo, cache, tokens, active, *a, **k)
        keep = torch.arange(tokens.shape[0]) >= tokens.shape[0] // 2
        return torch.where(keep, tokens, nxt)

    monkeypatch.setattr(serving, "_batched_decode_step", half)
    out = load_module("drivers", "closed_loop").run(cpu_context("closed", seconds=2.0))
    assert not correct(out), out.checks


def test_a_training_step_that_keeps_its_state_reads_not_correct(cpu_context, monkeypatch):
    from duo_attention_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.GateTrainer, "apply_grads", lambda self: None)
    out = load_module("drivers", "gate_train").run(cpu_context("train", seconds=0.2))
    assert not correct(out), out.checks
    assert dict((n, v) for n, v, _ in out.checks)["train_change_gap"] == pytest.approx(1.0)


def test_router_margins_and_the_judged_tokens(cpu_context):
    """A MoE reference reports each served position's smallest router margin;
    with ``served_router_margin`` set, only positions at or above it are
    judged."""
    from port_bench.core import serve
    from port_bench.reference.model import logits_at

    ctx = cpu_context("closed", moe=True)
    prompt = np.random.default_rng(0).integers(0, 512, 100)
    served = list(np.random.default_rng(1).integers(0, 512, 9))
    margins = []
    logits = logits_at(ctx.conf, ctx.seed, [(prompt, served)], "cpu", margins=margins)
    assert len(margins) == 1 and margins[0].shape == (9,) and (margins[0] >= 0).all()
    g = np.arange(9, dtype=np.float32)
    assert np.array_equal(serve.judged(ctx, g, margins), g)
    ctx.limits["served_router_margin"] = float(np.median(margins[0]))
    kept = serve.judged(ctx, g, margins)
    assert np.array_equal(kept, g[margins[0] >= np.median(margins[0])]) and 0 < len(kept) < 9
    dense = cpu_context("closed")
    none = []
    logits_at(dense.conf, dense.seed, [(prompt, served)], "cpu", margins=none)
    assert none == []


def test_a_moe_cell_compares_its_mean_judged_gap(cpu_context, monkeypatch):
    """With ``served_mean_gap`` and ``served_router_margin`` the check is the
    mean gap of the tokens the margin lets through; an altered token fails it."""
    from duo_attention_tpu_torch import serving

    ctx = cpu_context("closed", moe=True)
    ctx.limits.clear()
    ctx.limits.update(served_router_margin=0.0, served_mean_gap=0.3)
    out = load_module("drivers", "closed_loop").run(ctx)
    assert [n for n, _, _ in out.checks] == ["served_mean_gap"] and correct(out), out.checks
    real = serving._batched_decode_step
    monkeypatch.setattr(serving, "_batched_decode_step",
                        lambda *a, **k: torch.remainder(real(*a, **k) + 1, 512))
    ctx = cpu_context("closed", moe=True)
    ctx.limits.clear()
    ctx.limits.update(served_router_margin=0.0, served_mean_gap=0.3)
    assert not correct(load_module("drivers", "closed_loop").run(ctx))
