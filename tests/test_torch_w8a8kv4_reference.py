"""The W8A8KV4 serving path held to the benchmark's plain reference of the
format (``port_bench/reference/w8a8kv4.py``), and the ``engine.quantize_act``
span of its activation quantization.

A tiny model (2 layers, GQA 4/2, head_dim 64, sink 4, recent 8, chunk 16,
cache 128; one full and one streaming KV head a layer) is served through
the W8A8KV4 ``ServingEngine`` on the CPU's plain paths: 2 slots, three
requests, so a freed slot is admitted again while the INT4 decode still
reads its stale row. Its weights are ``port_bench/core/weights.py``'s draw,
quantized by ``ops/quant.py``; the engine runs in float32 (norms, residual
stream and streaming cache), so what remains between it and the reference
is float32 rounding. Every logit the engine computes for a served token
(the last prefill chunk's, then each pool step's row) is compared with the
reference's at that position.
"""

import types

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch import tracing
from duo_attention_tpu_torch.engine import DuoEngine
from duo_attention_tpu_torch.models import llama
from duo_attention_tpu_torch.ops.quant import quantize_embeddings_int8, quantize_params_w8a8
from duo_attention_tpu_torch.serving import Request, ServingEngine
from port_bench.core.serve import build_program
from port_bench.core.weights import Shape, make_params
from port_bench.reference import w8a8kv4

SEED = 2**31 + 77
CONF = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "max_position_embeddings": 128, "model_type": "mistral",
        "duo": {"sink_size": 4, "recent_size": 8, "prefill_chunk_size": 16, "max_cache_size": 128,
                "full_kv_heads": [[0], [1]]}}
PROMPTS = (45, 70, 30)  # three chunked prompts over two slots: the third reuses a freed slot
OUTPUTS = (12, 20, 16)
# |program - reference| over every served logit. Both compute the same
# roundings from float32 values, so they agree to float32 rounding (~1e-6)
# until a summation-order difference pushes one int8 activation across a
# rounding boundary. The tokens downstream of it then move by ~0.2%, which
# can move an INT4 row's bf16-stored zero point and re-round the nibbles
# that lie near a boundary by a whole step (a fifteenth of the row's range):
# over 5 seeds at this size such a token moved the logits after it by at
# most 0.08, and 3 seeds had none (0 to 1e-6). Leaving out the INT4 cache
# moved them by 0.51-0.73, leaving out the W8A8 rounding by 0.37-0.49
# (``test_each_half_of_the_format_is_needed``).
TOLERANCE = 0.15


def program_params():
    """The reference's weights in float32, quantized by the program, with
    the retrieval heads first."""
    params = make_params(Shape.of(CONF), SEED, "cpu")
    params = {k: ([{n: t.float() for n, t in layer.items()} for layer in v] if k == "layers" else v.float())
              for k, v in params.items()}
    params = quantize_embeddings_int8(quantize_params_w8a8(params))
    return build_program(types.SimpleNamespace(conf=CONF, seed=SEED, device=torch.device("cpu")), params)


@pytest.fixture(scope="module")
def served():
    """(requests, the engine's logits for each served token) of one run."""
    params, cfg, duo = program_params()
    eng = ServingEngine(params, cfg, duo, max_batch_size=2, dtype=torch.float32, kv_quant="int4",
                        decode_burst=1, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt_ids=rng.integers(0, 512, n), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPTS, OUTPUTS))]
    got = {r.rid: {} for r in reqs}  # rid -> {index of the served token: its logits}
    real = llama.logits_at

    def logits_at(params, hidden, index, *a, **k):
        out = real(params, hidden, index, *a, **k)
        if hidden.shape[1] > 1:  # an admission chunk: the latest chunk's logits choose the first token
            got[eng._admitting[0].rid][0] = out[0]
        else:  # a pool step: row i chooses the next token of slot i's request
            for i, req in enumerate(eng.slots):
                if req is not None:
                    got[req.rid][len(req.generated)] = out[i]
        return out

    llama.logits_at = logits_at
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        llama.logits_at = real
    assert eng.stale.max() > 0 and reqs[2].slot in (reqs[0].slot, reqs[1].slot)
    for r in reqs:
        assert sorted(got[r.rid]) == list(range(len(r.generated)))
    return reqs, {rid: torch.stack([g[i] for i in sorted(g)]) for rid, g in got.items()}


def reference(reqs, **kw):
    return w8a8kv4.logits_at(CONF, SEED, [(r.prompt_ids, r.generated) for r in reqs], "cpu", **kw)


def gap(reqs, logits, ref) -> float:
    return max(float((logits[r.rid] - lg).abs().max()) for r, lg in zip(reqs, ref))


def test_the_served_logits_agree_with_the_reference(served):
    reqs, logits = served
    assert gap(reqs, logits, reference(reqs)) <= TOLERANCE
    # the greedy pool chose each served token as the argmax of the logits compared
    for r in reqs:
        assert logits[r.rid].argmax(dim=-1).tolist() == r.generated


@pytest.mark.parametrize("part", ["kv4", "w8a8"])
def test_each_half_of_the_format_is_needed(served, part):
    """The reference without the INT4 cache, or without the W8A8 rounding,
    lies outside the tolerance."""
    reqs, logits = served
    left_out = {"kv4": {"kv_bits": None}, "w8a8": {"weight_bits": None}}[part]
    assert gap(reqs, logits, reference(reqs, **left_out)) > 2 * TOLERANCE


def test_the_reference_writes_out_the_published_roundings():
    """int8: amax / 127 + 1e-12 per row, rounded and clipped; INT4: (max -
    min) / 15 + 1e-8 per (token, head), read back through bf16 scale and
    zero point; both as ``ops/quant.py`` computes them."""
    from duo_attention_tpu_torch.ops.quant import dequantize_int4, quantize_int4, quantize_weight_int8

    x = torch.randn(7, 3, 64, generator=torch.Generator().manual_seed(0))
    packed, scales = quantize_int4(x)
    assert torch.equal(w8a8kv4.int_heads(x), dequantize_int4(packed, scales))
    w = torch.randn(32, 48, generator=torch.Generator().manual_seed(1))
    q, s = quantize_weight_int8(w)
    rq, rs = w8a8kv4.int_rows(w)
    assert torch.equal(rq, q.float()) and torch.equal(rs[:, 0], s)


def test_quantize_act_spans_one_a_projection_group_a_chunk():
    """Inside ``recording()``: one ``engine.quantize_act`` span in each
    ``engine.prefill_chunk`` for each projection group of each layer (wq+wk+wv,
    wo, w_gate+w_up, w_down) and for the head; none outside it, and none in
    the bf16 format."""
    params, cfg, duo = program_params()
    prompt = np.arange(40) % 512  # 3 chunks
    tracing.clear()
    with tracing.recording():
        DuoEngine(params, cfg, duo, batch_size=1, dtype=torch.float32, kv_quant="int4", device="cpu").prefill(prompt[None])
    got = tracing.spans()
    chunks = [s.id for s in got if s.name == "engine.prefill_chunk"]
    quant = [s for s in got if s.name == "engine.quantize_act"]
    assert len(chunks) == 3
    assert all(sum(s.parent == c for s in quant) == 4 * cfg.num_layers + 1 for c in chunks)
    assert len(quant) == 3 * (4 * cfg.num_layers + 1)

    tracing.clear()
    DuoEngine(params, cfg, duo, batch_size=1, dtype=torch.float32, kv_quant="int4", device="cpu").prefill(prompt[None])
    assert tracing.spans() == []

    bf16 = make_params(Shape.of(CONF), SEED, "cpu")
    bf16, cfg, duo = build_program(types.SimpleNamespace(conf=CONF, seed=SEED, device=torch.device("cpu")), bf16)
    eng = DuoEngine(bf16, cfg, duo, batch_size=1, device="cpu")
    with tracing.recording():
        eng.prefill(prompt[None])
    names = {s.name for s in tracing.spans()}
    tracing.clear()
    assert "engine.prefill_chunk" in names and "engine.quantize_act" not in names


def test_no_quantize_act_span_opens_during_a_capture(monkeypatch):
    """A CUDA x quantized while its stream captures a graph (the pool's
    decode step) gets ``tracing.NULL``, recording or not."""
    from duo_attention_tpu_torch.ops import quant

    x = types.SimpleNamespace(is_cuda=True, device=torch.device("cpu"))  # a card's tensor, without the card
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    tracing.clear()
    with tracing.recording():
        with quant._quantize_span(x) as sp:
            assert sp and sp.name == "engine.quantize_act"
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert quant._quantize_span(x) is tracing.NULL
    assert [s.name for s in tracing.spans()] == ["engine.quantize_act"]
    tracing.clear()
    assert quant._quantize_span(x) is tracing.NULL
