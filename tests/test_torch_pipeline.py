"""The port's pipeline-parallel engine (parallel/pipeline.py) against its
one-device engine and the JAX package's PipelinedEngine, on the CPU.

Mirrors tests/test_pipeline.py (the bounds, the stage placement, generation
equal to one device with a head split crossing the stage bounds, stop
tokens, the W8A8KV4 format), and holds ``forward_chunk`` fed hidden states
with no final norm (a stage's call) to JAX's. The port's stages run on the
CPU in one process; JAX's on 2-4 of the 8 virtual CPU devices of
tests/conftest.py. float32: tokens equal, logits within 1e-4; W8A8 under
the flip bounds of tests/test_torch_quant.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.cache import init_cache as j_init_cache
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu.parallel.pipeline import PipelinedEngine as JPipelinedEngine
from duo_attention_tpu_torch import DuoEngine, init_cache, kv_memory_bytes
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.parallel.pipeline import (
    PipelinedEngine,
    balanced_stage_bounds,
    split_stage_params,
    stage_devices,
)
from test_torch_model import duos, models
from test_torch_quant import FLIP_LOGIT_GAP, FLIP_REL_FRO, TIGHT_ATOL, rel_fro, w8a8_models

torch.set_num_threads(1)
LOGIT_ATOL = 1e-4
W8A8_SEEDS = (5, 6, 7, 8)
FOUR_LAYERS = dict(port={"num_layers": 4}, jax={"num_layers": 4})


@pytest.fixture(scope="module")
def model():
    """tiny-gqa at 4 layers (the JAX test's depth), float32, from a numpy seed."""
    return models("tiny-gqa", 3, **FOUR_LAYERS)


def _ids(cfg, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, S)).astype(np.int32)


def test_balanced_bounds():
    assert balanced_stage_bounds(8, 4) == [0, 2, 4, 6, 8]
    assert balanced_stage_bounds(7, 4) == [0, 2, 4, 6, 7]  # the remainder to the leading stages
    assert balanced_stage_bounds(5, 2) == [0, 3, 5]
    assert balanced_stage_bounds(4, 1) == [0, 4]
    with pytest.raises(ValueError):
        balanced_stage_bounds(2, 3)


def test_stage_params_placement(model):
    """Stage 0 holds the embedding, the last the final norm and the head;
    a tied model's last stage holds the embedding too (int8 tables alike)."""
    tcfg, _, tp, _ = model
    stages, bounds = split_stage_params(tp, 3)
    assert bounds == [0, 2, 3, 4]
    assert "embed" in stages[0] and "embed" not in stages[1] and "embed" not in stages[2]
    assert "final_norm" in stages[-1] and "lm_head" in stages[-1] and "final_norm" not in stages[0]
    assert sum(len(s["layers"]) for s in stages) == tcfg.num_layers
    assert stages[1]["layers"][0] is tp["layers"][2]
    tied = {k: v for k, v in tp.items() if k != "lm_head"}
    stages, _ = split_stage_params(tied, 2)
    assert stages[-1]["embed"] is tied["embed"] and "embed" in stages[0]
    q8 = {"embed_q8": tp["embed"].to(torch.int8), "embed_scale": tp["final_norm"], "final_norm": tp["final_norm"],
          "layers": tp["layers"]}
    stages, _ = split_stage_params(q8, 2)
    assert set(stages[-1]) == {"layers", "final_norm", "embed_q8", "embed_scale"}
    assert set(stages[0]) == {"layers", "embed_q8", "embed_scale"}


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_pipeline_matches_single_device_and_jax(model, n_stages):
    """2-, 3- and 4-stage generate equal to the port's DuoEngine and to JAX's
    PipelinedEngine, with a per-layer head split crossing the stage bounds;
    prefill logits within 1e-4 of both; each stage's cache on its device and
    at the whole length; the stages' KV bytes sum to the one cache's."""
    tcfg, jcfg, tp, jp = model
    tduo, jduo = duos(tcfg, (2, 0, 1, 2))
    ids = _ids(tcfg, 40, 0)
    one = DuoEngine(tp, tcfg, tduo, dtype=torch.float32, device="cpu")
    want, ref_cache = one.generate(ids, 9)
    pipe = PipelinedEngine(tp, tcfg, tduo, devices=["cpu"] * n_stages, dtype=torch.float32)
    got, caches = pipe.generate(ids, 9)
    np.testing.assert_array_equal(got, want)
    jpipe = JPipelinedEngine(jp, jcfg, jduo, devices=jax.devices()[:n_stages], dtype=jnp.float32)
    jgot, _ = jpipe.generate(ids, 9)
    np.testing.assert_array_equal(got, np.asarray(jgot))
    _, logits = pipe.prefill(ids)
    _, one_logits = one.prefill(ids)
    _, jlogits = jpipe.prefill(ids)
    np.testing.assert_allclose(logits.numpy(), one_logits.numpy(), atol=LOGIT_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
    assert pipe.shares_a_card and len(caches) == n_stages
    for cache, dev in zip(caches, pipe.devices):
        assert int(cache.length) == 40 + 9 and cache.k_ring[0].device == dev
    assert pipe.kv_memory_bytes(caches) == kv_memory_bytes(ref_cache)
    assert [len(d.num_full_kv_heads) for d in pipe.stage_duos] == [b - a for a, b in zip(pipe.bounds, pipe.bounds[1:])]


def test_pipeline_stop_tokens(model):
    tcfg, _, tp, _ = model
    tduo, _ = duos(tcfg, (1, 1, 1, 1))
    ids = _ids(tcfg, 20, 1)
    pipe = PipelinedEngine(tp, tcfg, tduo, devices=["cpu", "cpu"], dtype=torch.float32)
    free, _ = pipe.generate(ids, 12)
    stop = int(free[0, 3])
    tokens, _ = pipe.generate(ids, 12, stop_token_ids=[stop])
    assert tokens.shape == (1, 12)
    first = int(np.argmax(tokens[0] == stop))
    assert first <= 3 and (tokens[0, first + 1 :] == stop).all()
    np.testing.assert_array_equal(tokens[0, : first + 1], free[0, : first + 1])


def test_pipeline_w8a8kv4_matches_single_device(model):
    """W8A8 linears, int8 embedding and head (stage 0 holds embed_q8 and no
    final norm) and INT4 caches a stage: the port's pipeline gives its
    DuoEngine's prefill logits and tokens bit for bit (the same kernels in
    the same order); against JAX's PipelinedEngine the prefill logits are
    within the flip bound on every input and within TIGHT_ATOL on one, and
    a stream departs from JAX's only where JAX's token is within
    FLIP_LOGIT_GAP of the port's best. One decode step of both stages
    advances both caches."""
    tcfg, jcfg, tp, jp = w8a8_models("tiny-gqa", 5, **FOUR_LAYERS)
    tduo, jduo = duos(tcfg, (1, 2, 0, 1))
    tight = 0
    one = DuoEngine(tp, tcfg, tduo, dtype=torch.float32, device="cpu", kv_quant="int4")
    pipe = PipelinedEngine(tp, tcfg, tduo, devices=["cpu", "cpu"], dtype=torch.float32, kv_quant="int4")
    jpipe = JPipelinedEngine(jp, jcfg, jduo, devices=jax.devices()[:2], dtype=jnp.float32, kv_quant="int4")
    for seed in W8A8_SEEDS:
        ids = _ids(tcfg, 24, seed)
        caches, logits = pipe.prefill(ids)
        _, one_logits = one.prefill(ids)
        np.testing.assert_array_equal(logits.numpy(), one_logits.numpy())
        got, _ = pipe.generate(ids, 6)
        np.testing.assert_array_equal(got, one.generate(ids, 6)[0])
        _, jl = jpipe.prefill(ids)
        assert rel_fro(logits.numpy(), np.asarray(jl)) <= FLIP_REL_FRO
        tight += float(np.abs(logits.numpy() - np.asarray(jl)).max()) <= TIGHT_ATOL
        jgot = np.asarray(jpipe.generate(ids, 6)[0])
        steps = np.nonzero(got[0] != jgot[0])[0]
        if len(steps):  # the port's own logits there, fed JAX's tokens so far, hold JAX's token near the top
            t = int(steps[0])
            c, lg = pipe.prefill(ids)
            for tok in jgot[0, :t]:
                hidden, c = pipe._run_chunk(c, torch.as_tensor([[int(tok)]]), 1, pipe.bucket_for(30))
                lg = pipe._logits(hidden, 0)
            assert float(lg[0].max() - lg[0, jgot[0, t]]) <= FLIP_LOGIT_GAP
    assert tight >= 1
    hidden, caches = pipe._run_chunk(caches, torch.as_tensor([[int(got[0, 0])]]), 1, pipe.bucket_for(25))
    assert np.isfinite(pipe._logits(hidden, 0).numpy()).all()
    assert [int(c.length) for c in caches] == [25, 25]


def test_forward_chunk_takes_stage_input(model):
    """A stage's call: forward_chunk fed hidden states [B, S, E] (no lookup)
    with params that hold no final norm returns the raw residual stream,
    equal to JAX's forward_chunk on the same input (1e-5), and the stage
    after it, fed that, ends in the final norm as one whole forward does."""
    tcfg, jcfg, tp, jp = model
    tduo, jduo = duos(tcfg, (2, 0, 1, 2))
    h = np.random.default_rng(9).standard_normal((1, 16, tcfg.hidden_size)).astype(np.float32)
    first = {"layers": tp["layers"][:2]}
    cfg2 = dataclasses.replace(tcfg, num_layers=2)
    duo2 = dataclasses.replace(tduo, num_full_kv_heads=(2, 0))
    with torch.no_grad():
        got, cache = tllama.forward_chunk(first, cfg2, duo2, init_cache(cfg2, duo2, 1, torch.float32, "cpu"),
                                          torch.as_tensor(h))
    jcfg2 = dataclasses.replace(jcfg, num_layers=2)
    jduo2 = dataclasses.replace(jduo, num_full_kv_heads=(2, 0))
    want, _ = jllama.forward_chunk({"layers": tuple(jp["layers"][:2])}, jcfg2, jduo2,
                                   j_init_cache(jcfg2, jduo2, 1, jnp.float32), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert int(cache.length) == 16
    # two stages by hand == the whole model
    ids = torch.as_tensor(_ids(tcfg, 16, 2)).long()
    stages, _ = split_stage_params(tp, 2)
    with torch.no_grad():
        x, _ = tllama.forward_chunk(stages[0], cfg2, duo2, init_cache(cfg2, duo2, 1, torch.float32, "cpu"), ids)
        duo_b = dataclasses.replace(tduo, num_full_kv_heads=(1, 2))
        x, _ = tllama.forward_chunk(stages[1], cfg2, duo_b, init_cache(cfg2, duo_b, 1, torch.float32, "cpu"), x)
        whole, _ = tllama.forward_chunk(tp, tcfg, tduo, init_cache(tcfg, tduo, 1, torch.float32, "cpu"), ids)
    np.testing.assert_array_equal(x.numpy(), whole.numpy())


def test_stage_devices_and_no_card():
    """--pp's devices: the CPU n times when asked for; the card by default,
    which raises with no GPU (nothing falls back to the CPU)."""
    assert stage_devices(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage_devices(2)
