"""The port's Mixtral MoE MLP against the JAX package's, on the CPU.

Counterparts of tests/test_moe.py (the router against a per-token numpy
loop, one expert equal to the dense MLP, Mixtral safetensors conversion and
forward with the reorder symmetry, the engine generating), then the greedy
token streams of ``DuoEngine`` on a tiny Mixtral against the JAX engine's
(float32 over the bf16-format cache, and W8A8 over the INT4 cache under the
flip bounds of tests/test_torch_quant.py), ``forward_two_way`` and its gate
gradient, the leaves of ``init_params_w8a8_random`` and the npz round trip.
Weights come from a numpy seed and feed both packages through
``from_jax.params_from_numpy``; each tolerance is stated where it is used.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import config as jconfig
from duo_attention_tpu.engine import DuoEngine as JDuoEngine
from duo_attention_tpu.models import convert as jconvert
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu.ops import quant as jquant
from duo_attention_tpu_torch import DuoConfig, DuoEngine, ModelConfig, init_params, init_params_w8a8
from duo_attention_tpu_torch.models import convert, llama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import quant
from test_torch_model import numpy_params
from test_torch_quant import FLIP_LOGIT_GAP

torch.set_num_threads(1)

# tests/test_moe.py's TINY_MIXTRAL, in both packages
_MIXTRAL = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=16, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)
TINY_MIXTRAL = ModelConfig(**_MIXTRAL)
J_TINY_MIXTRAL = jconfig.ModelConfig(**_MIXTRAL)
ATOL = 3e-4  # the port's forward against JAX's, float32 (tests/test_torch_model.py)


def mixtral(seed, w8a8=False):
    """(port params, JAX params) of TINY_MIXTRAL from a numpy seed (experts
    and router drawn as the other leaves are); with ``w8a8`` the seven
    projections, embedding and head quantized by the JAX package."""
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(J_TINY_MIXTRAL, seed))
    if w8a8:
        jp = jquant.quantize_embeddings_int8(jquant.quantize_params_w8a8(jp))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu", torch.float32), jp


def duos(num_full=(1, 1), max_size=256, chunk=32):
    kw = dict(sink_size=8, recent_size=16, num_full_kv_heads=tuple(num_full), max_cache_size=max_size,
              prefill_chunk_size=chunk)
    return DuoConfig(**kw), jconfig.DuoConfig(**kw)


def test_moe_router_semantics_vs_numpy():
    """Dense dispatch equals the per-token top-k loop (atol 2e-5, as JAX's)."""
    cfg = TINY_MIXTRAL
    tp, _ = mixtral(0)
    layer = tp["layers"][0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 5, cfg.hidden_size)).astype(np.float32))
    got = llama._moe_mlp(layer, x, cfg.num_experts_per_tok).numpy()

    xg = x.double().numpy()
    gate = layer["moe_gate"].double().numpy()  # [E, X]
    Wg, Wu, Wd = (layer[n].double().numpy() for n in ("experts_w_gate", "experts_w_up", "experts_w_down"))
    want = np.zeros_like(xg)
    for b in range(xg.shape[0]):
        for s in range(xg.shape[1]):
            tok = xg[b, s]
            logits = tok @ gate
            top = np.argsort(-logits)[: cfg.num_experts_per_tok]
            w = np.exp(logits[top] - logits[top].max())
            w = w / w.sum()
            for wi, e in zip(w, top):
                h = Wg[e] @ tok  # [out, in] layout
                act = h / (1 + np.exp(-h)) * (Wu[e] @ tok)
                want[b, s] += wi * (Wd[e] @ act)
    np.testing.assert_allclose(got, want, atol=2e-5)
    combine = llama.moe_router(layer, x, cfg.num_experts_per_tok)
    assert combine.dtype == torch.float32 and bool((combine > 0).sum(-1).eq(2).all())
    np.testing.assert_allclose(combine.sum(-1).numpy(), 1.0, atol=1e-6)


def test_moe_single_expert_equals_dense():
    """One expert with k = 1 and the dense layer's weights is the dense MLP
    (a softmax over one logit is exactly 1); atol 1e-5, as JAX's."""
    cfg = dataclasses.replace(TINY_MIXTRAL, num_local_experts=0)
    params = init_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    layer = params["layers"][0]
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1, 7, cfg.hidden_size)).astype(np.float32))
    want = llama._mlp(layer, x, cfg)
    moe_layer = {k: v for k, v in layer.items() if not k.startswith("w_")}
    moe_layer["moe_gate"] = torch.zeros((cfg.hidden_size, 1))
    for name in ("gate", "up", "down"):
        moe_layer[f"experts_w_{name}"] = layer[f"w_{name}"][None]
    np.testing.assert_allclose(llama._moe_mlp(moe_layer, x, 1).numpy(), want.numpy(), atol=1e-5)


def test_init_layer_draws_the_moe_leaves():
    """init_params of a Mixtral config: the router [E, X] float32 and the
    experts stacked [X, out, in], no dense MLP; the forward runs."""
    cfg = TINY_MIXTRAL
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    layer = params["layers"][0]
    E, I, X = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    assert layer["moe_gate"].shape == (E, X) and layer["moe_gate"].dtype == torch.float32
    assert layer["experts_w_gate"].shape == layer["experts_w_up"].shape == (X, I, E)
    assert layer["experts_w_down"].shape == (X, E, I) and layer["experts_w_down"].dtype == torch.bfloat16
    assert not any(k.startswith("w_") for k in layer)
    h = llama.forward_full_attention(params, cfg, torch.zeros((1, 9), dtype=torch.long))
    assert h.shape == (1, 9, E) and bool(torch.isfinite(h.float()).all())


def _mixtral_state_dict(params, cfg):
    """HF-layout export of the port's Mixtral params (HF keeps [out, in], as the port does)."""
    state = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
             "lm_head.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        for hf, ours in (("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"), ("self_attn.v_proj", "wv"),
                         ("self_attn.o_proj", "wo"), ("input_layernorm", "input_norm"),
                         ("post_attention_layernorm", "post_norm"), ("block_sparse_moe.gate", None)):
            state[pre + hf + ".weight"] = layer["moe_gate"].t() if ours is None else layer[ours]
        for e in range(cfg.num_local_experts):
            for hf, ours in (("w1", "experts_w_gate"), ("w3", "experts_w_up"), ("w2", "experts_w_down")):
                state[f"{pre}block_sparse_moe.experts.{e}.{hf}.weight"] = layer[ours][e]
    return {k: np.ascontiguousarray(v.float().numpy()) for k, v in state.items()}


def test_mixtral_convert_and_forward(tmp_path):
    """A Mixtral safetensors checkpoint (block_sparse_moe names) converts
    back to the params it came from bit for bit, and to the JAX loader's
    params; its forward equals JAX's (atol 3e-4); the head reorder stays a
    symmetry with the MoE leaves carried through untouched (atol 1e-4, as
    JAX's)."""
    from safetensors.numpy import save_file

    cfg = TINY_MIXTRAL
    tp, jp = mixtral(4)
    save_file(_mixtral_state_dict(tp, cfg), os.path.join(tmp_path, "model.safetensors"))
    loaded = convert.params_from_state_dict(convert._load_state_dict(str(tmp_path)), cfg, torch.float32,
                                            device="cpu")
    jloaded = jconvert.params_from_state_dict(jconvert._load_state_dict(str(tmp_path)), J_TINY_MIXTRAL,
                                              jnp.float32)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jloaded), "cpu", torch.float32)
    for got in (loaded, carried):
        assert got.keys() == tp.keys()
        for la, lb in zip(got["layers"], tp["layers"]):
            assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    assert loaded["layers"][0]["moe_gate"].dtype == torch.float32

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 24))
    ref = llama.forward_full_attention(tp, cfg, torch.as_tensor(ids))
    np.testing.assert_allclose(llama.forward_full_attention(loaded, cfg, torch.as_tensor(ids)).numpy(),
                               np.asarray(jllama.forward_full_attention(jp, J_TINY_MIXTRAL, jnp.asarray(ids))),
                               atol=ATOL)
    gates = (np.random.default_rng(5).uniform(size=(cfg.num_layers, cfg.num_kv_heads)) > 0.5).astype(float)
    reordered, _ = convert.reorder_params(loaded, cfg, gates)
    for la, lb in zip(reordered["layers"], loaded["layers"]):
        assert all(la[k] is lb[k] for k in la if k.startswith(("moe", "experts")))
    np.testing.assert_allclose(llama.forward_full_attention(reordered, cfg, torch.as_tensor(ids)).numpy(),
                               ref.numpy(), atol=1e-4)


def test_mixtral_checkpoint_missing_its_experts_raises(tmp_path):
    """A Mixtral config over a checkpoint with no block_sparse_moe tensors names what is missing."""
    cfg = TINY_MIXTRAL
    tp, _ = mixtral(4)
    state = {k: v for k, v in _mixtral_state_dict(tp, cfg).items() if "block_sparse_moe.experts" not in k}
    with pytest.raises(KeyError, match="block_sparse_moe.experts.0.w1"):
        convert.params_from_state_dict(state, cfg, torch.float32, device="cpu")


def test_mixtral_engine_generate():
    """The port's engine (chunked prefill, then decode) runs a Mixtral config."""
    cfg = TINY_MIXTRAL
    tduo, _ = duos()
    tp, _ = mixtral(6)
    eng = DuoEngine(tp, cfg, tduo, batch_size=1, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 50))
    toks, cache = eng.generate(prompt, max_new_tokens=5)
    assert toks.shape == (1, 5)
    assert int(cache.length) == 55


@pytest.mark.parametrize("num_full", [(1, 1), (0, 2)])
def test_mixtral_greedy_stream_matches_jax(num_full):
    """TINY_MIXTRAL's greedy stream through DuoEngine equals the JAX
    engine's token for token (float32, the bf16-format cache; 50-token
    prompts in chunks of 32 and a partial 18, then 12 tokens), for three
    prompts."""
    cfg = TINY_MIXTRAL
    tduo, jduo = duos(num_full)
    tp, jp = mixtral(7)
    jeng = JDuoEngine(jp, J_TINY_MIXTRAL, jduo, dtype=jnp.float32)
    eng = DuoEngine(tp, cfg, tduo, batch_size=1, dtype=torch.float32, device="cpu")
    for seed in range(3):
        ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 50))
        want, jc = jeng.generate(ids, max_new_tokens=12)
        got, tc = eng.generate(ids, max_new_tokens=12)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert int(tc.length) == int(jc.length) == 62


def test_mixtral_w8a8_int4_stream_matches_jax():
    """W8A8 TINY_MIXTRAL (the seven projections, embedding and head int8;
    router and experts float32, as JAX leaves them) through
    DuoEngine(kv_quant="int4") against JAX's, four prompts: equal streams,
    except that a rounding flip (tests/test_torch_quant.py) may turn a
    near-tie, where the port's own logits for the step, with JAX's tokens
    fed so far, hold JAX's token within FLIP_LOGIT_GAP of the best; at least
    three of four streams equal outright."""
    cfg = TINY_MIXTRAL
    tduo, jduo = duos((1, 2))
    tp, jp = mixtral(8, w8a8=True)
    assert "experts_w_gate" in tp["layers"][0] and "wq_q8" in tp["layers"][0] and "embed_q8" in tp
    jeng = JDuoEngine(jp, J_TINY_MIXTRAL, jduo, dtype=jnp.float32, kv_quant="int4")
    eng = DuoEngine(tp, cfg, tduo, batch_size=1, dtype=torch.float32, device="cpu", kv_quant="int4")
    equal = 0
    for seed in range(10, 14):
        ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 41))
        want, _ = jeng.generate(ids, max_new_tokens=10)
        want = np.asarray(want)
        got, tc = eng.generate(ids, max_new_tokens=10)
        assert int(tc.length) == 51
        if np.array_equal(got, want):
            equal += 1
            continue
        i = int(np.nonzero(got[0] != want[0])[0][0])
        _, logits = eng.prefill(np.concatenate([ids, want[:, :i]], axis=1))
        assert float(logits[0].max() - logits[0, want[0, i]]) <= FLIP_LOGIT_GAP
    assert equal >= 3


def test_mixtral_two_way_matches_jax():
    """forward_two_way on TINY_MIXTRAL: teacher and student (atol 1e-5) and
    the gate gradient of mean((t - s)^2) (atol 1e-5) against jax.grad,
    float32, gates inside the clip."""
    cfg = TINY_MIXTRAL
    tp, jp = mixtral(9)
    sink, recent, block = 4, 8, 16
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 48))
    gates = np.random.default_rng(3).uniform(0.1, 0.9, (cfg.num_layers, cfg.num_kv_heads)).astype(np.float32)

    def loss(g):
        tt, ss = jllama.forward_two_way(jp, g, J_TINY_MIXTRAL, sink, recent, jnp.asarray(ids), block_k=block)
        return jnp.mean((tt - ss) ** 2), (tt, ss)

    (_, (jt, js)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(gates))
    g = torch.tensor(gates, requires_grad=True)
    tt, ss = llama.forward_two_way(tp, g, cfg, sink, recent, torch.as_tensor(ids), block_k=block)
    ((tt - ss) ** 2).mean().backward()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(ss.detach().numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), atol=1e-5)
    assert float(np.abs(g.grad.numpy()).max()) > 0


@pytest.mark.parametrize("quantize_embeds", [True, False])
def test_init_params_w8a8_random_leaves_match_jax(quantize_embeds):
    """As JAX's, init_params_w8a8_random draws dense int8 layers whatever
    num_local_experts says: the same leaf names, and the same shapes (the
    port's [out, in] being JAX's [in, out] transposed)."""
    cfg = TINY_MIXTRAL
    got = quant.init_params_w8a8_random(cfg, seed=0, device="cpu", quantize_embeds=quantize_embeds)
    want = jax.eval_shape(lambda: jquant.init_params_w8a8_random(J_TINY_MIXTRAL, jax.random.PRNGKey(0),
                                                                 quantize_embeds=quantize_embeds))

    def shape(name, jleaf):
        s = tuple(jleaf.shape)
        return s[::-1] if len(s) == 2 and name not in ("embed", "embed_q8") else s

    assert set(got) == set(want)
    for name in got:
        if name != "layers":
            assert tuple(got[name].shape) == shape(name, want[name]), name
    for lt, lj in zip(got["layers"], want["layers"]):
        assert set(lt) == set(lj)
        assert all(tuple(lt[n].shape) == shape(n, lj[n]) for n in lt)


def test_init_params_w8a8_quantizes_the_projections_of_a_moe_model():
    """init_params_w8a8 on a Mixtral config: the seven attention and MLP
    projections that exist become int8 (here the four of attention); the
    router and the experts stay in high precision, as JAX's quantization
    leaves them."""
    params = init_params_w8a8(TINY_MIXTRAL, seed=0, device="cpu", quantize_embeds=True)
    layer = params["layers"][0]
    assert {"wq_q8", "wk_q8", "wv_q8", "wo_q8"} <= set(layer) and "wq" not in layer
    assert layer["moe_gate"].dtype == torch.float32 and layer["experts_w_down"].dtype == torch.bfloat16
    assert not any(k.startswith("w_") for k in layer)


def test_npz_roundtrip_with_moe_leaves(tmp_path):
    """save_params_npz / load_params_npz keep the router (float32) and the
    bf16 experts bit for bit."""
    cfg = TINY_MIXTRAL
    params = init_params(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    path = os.path.join(tmp_path, "params.npz")
    convert.save_params_npz(params, path)
    loaded = convert.load_params_npz(path, cfg, device="cpu")
    for la, lb in zip(loaded["layers"], params["layers"]):
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
    assert loaded["layers"][1]["moe_gate"].dtype == torch.float32
