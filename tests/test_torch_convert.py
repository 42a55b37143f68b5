"""The port's HF checkpoint conversion (models/convert.py), on the CPU.

Counterparts of tests/test_convert.py and tests/test_native.py: conversion
round-trips exactly, reordering KV heads (with the o projection's matching
columns) leaves the full-attention forward unchanged, the fused one-pass
reorder equals convert-then-reorder bitwise, and the gather that reads the
checkpoint equals numpy's. The port keeps HF's [out, in] layout, so where
the JAX package's native engine transposes and gathers, the port only
gathers (``index_select`` on the mmap'd view). The same synthetic
checkpoint loaded through both packages' ``load_hf_model`` gives the same
weights.
"""

import dataclasses
import json
import warnings
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.config import PRESETS as JPRESETS
from duo_attention_tpu.models import convert as jconvert
from duo_attention_tpu.models.synth import write_synth_checkpoint
from duo_attention_tpu_torch.config import PRESETS
from duo_attention_tpu_torch.models import convert, llama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import quant
from duo_attention_tpu_torch.patterns import head_permutation
from test_torch_model import numpy_params

torch.set_num_threads(1)

HF_NAMES = [("self_attn.q_proj.weight", "wq"), ("self_attn.k_proj.weight", "wk"),
            ("self_attn.v_proj.weight", "wv"), ("self_attn.o_proj.weight", "wo"),
            ("mlp.gate_proj.weight", "w_gate"), ("mlp.up_proj.weight", "w_up"),
            ("mlp.down_proj.weight", "w_down"), ("input_layernorm.weight", "input_norm"),
            ("post_attention_layernorm.weight", "post_norm")]


def hf_state_dict_from_params(params):
    """Inverse of params_from_state_dict: HF names, [out, in] as the port keeps them."""
    state = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        state["lm_head.weight"] = params["lm_head"]
    for i, layer in enumerate(params["layers"]):
        for hf, ours in HF_NAMES:
            state[f"model.layers.{i}.{hf}"] = layer[ours]
    return {k: np.ascontiguousarray(v.float().numpy()) for k, v in state.items()}


def write_hf_dir(path, params, cfg):
    from safetensors.numpy import save_file

    save_file(hf_state_dict_from_params(params), os.path.join(path, "model.safetensors"))
    hf_cfg = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
              "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
              "max_position_embeddings": cfg.max_position_embeddings, "model_type": cfg.model_type}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)


@pytest.fixture(scope="module")
def tiny():
    cfg = PRESETS["tiny-gqa"]
    params = params_from_numpy(numpy_params(JPRESETS["tiny-gqa"], 7), "cpu", torch.float32)
    return cfg, params


def ids_of(cfg, seed, n):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n)))


def assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    for k in a:
        if k != "layers":
            assert torch.equal(a[k], b[k]), k


def test_safetensors_roundtrip(tmp_path, tiny):
    cfg, params = tiny
    write_hf_dir(tmp_path, params, cfg)
    loaded = convert.params_from_state_dict(convert._load_state_dict(str(tmp_path)), cfg, torch.float32,
                                            device="cpu")
    assert_params_equal(loaded, params)
    ids = ids_of(cfg, 0, 24)
    assert torch.equal(llama.forward_full_attention(loaded, cfg, ids), llama.forward_full_attention(params, cfg, ids))


def test_torch_bin_shards_load(tmp_path, tiny):
    """Without safetensors shards, ``pytorch_model*.bin`` shards load (as float32)."""
    cfg, params = tiny
    state = {k: torch.from_numpy(v).bfloat16() for k, v in hf_state_dict_from_params(params).items()}
    names = sorted(state)
    torch.save({k: state[k] for k in names[::2]}, os.path.join(tmp_path, "pytorch_model-00001.bin"))
    torch.save({k: state[k] for k in names[1::2]}, os.path.join(tmp_path, "pytorch_model-00002.bin"))
    loaded = convert.params_from_state_dict(convert._load_state_dict(str(tmp_path)), cfg, torch.bfloat16,
                                            device="cpu")
    assert torch.equal(loaded["layers"][1]["wo"], params["layers"][1]["wo"].bfloat16())
    assert torch.equal(loaded["embed"], params["embed"].bfloat16())


def test_reorder_is_model_symmetry(tiny):
    """Permuting KV heads (with matching o columns) does not change the
    full-attention forward: what makes the deploy-time reorder sound."""
    cfg, params = tiny
    rng = np.random.default_rng(1)
    gates = (rng.uniform(size=(cfg.num_layers, cfg.num_kv_heads)) > 0.5).astype(float)
    reordered, num_full = convert.reorder_params(params, cfg, gates)
    assert num_full == tuple(int(r.sum()) for r in gates)
    ids = ids_of(cfg, 1, 32)
    torch.testing.assert_close(llama.forward_full_attention(reordered, cfg, ids),
                               llama.forward_full_attention(params, cfg, ids), rtol=2e-5, atol=2e-5)


def test_fused_convert_reorder_matches_two_pass(tmp_path, tiny):
    """load-time fused gather + reorder equals converting without a perm and
    then calling reorder_params, bitwise."""
    cfg, params = tiny
    write_hf_dir(tmp_path, params, cfg)
    raw = convert._load_state_dict(str(tmp_path))
    gates = (np.random.default_rng(9).uniform(size=(cfg.num_layers, cfg.num_kv_heads)) > 0.5).astype(float)
    perms = [head_permutation(g)[0] for g in gates]
    fused = convert.params_from_state_dict(raw, cfg, torch.float32, layer_perms=perms, device="cpu")
    two_pass, _ = convert.reorder_params(convert.params_from_state_dict(raw, cfg, torch.float32, device="cpu"),
                                         cfg, gates)
    assert_params_equal(fused, two_pass)


def test_reorder_quantized_equals_quantize_after_reorder(tiny):
    """The W8A8 branch of reorder_layer (int8 rows with their scales, o's int8
    columns) equals quantizing the reordered weights, bitwise."""
    cfg, params = tiny
    gates = (np.random.default_rng(4).uniform(size=(cfg.num_layers, cfg.num_kv_heads)) > 0.5).astype(float)
    a, nf_a = convert.reorder_params(quant.quantize_params_w8a8(params), cfg, gates)
    reordered, nf_b = convert.reorder_params(params, cfg, gates)
    b = quant.quantize_params_w8a8(reordered)
    assert nf_a == nf_b
    assert_params_equal(a, b)


def test_reorder_permutation_structure():
    perm, nf = head_permutation(np.array([0.0, 1.0, 0.0, 1.0]))
    assert nf == 2
    np.testing.assert_array_equal(perm, [1, 3, 0, 2])  # stable: full heads 1, 3, then 0, 2


def test_load_hf_model_end_to_end(tmp_path, tiny):
    from duo_attention_tpu_torch import DuoEngine

    cfg, params = tiny
    write_hf_dir(tmp_path, params, cfg)
    gates = np.ones((cfg.num_layers, cfg.num_kv_heads))
    gates[:, 0] = 0.0  # one streaming head a layer
    p2, cfg2, duo = convert.load_hf_model(str(tmp_path), gates, sink_size=16, recent_size=32, max_cache_size=256,
                                          prefill_chunk_size=64, dtype=torch.float32, device="cpu")
    assert cfg2.num_kv_heads == cfg.num_kv_heads
    assert duo.num_full_kv_heads == (cfg.num_kv_heads - 1,) * cfg.num_layers
    eng = DuoEngine(p2, cfg2, duo, dtype=torch.float32, device="cpu")
    toks, cache = eng.generate(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 48)), max_new_tokens=4)
    assert toks.shape == (1, 4)
    assert int(cache.length) == 48 + 4


def test_load_hf_model_defaults_to_the_card(tmp_path, tiny, monkeypatch):
    cfg, params = tiny
    write_hf_dir(tmp_path, params, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_hf_model(str(tmp_path), np.ones((cfg.num_layers, cfg.num_kv_heads)), 16, 32)


def test_moe_checkpoints_raise(tmp_path, tiny):
    """A Mixtral config over a dense checkpoint (no block_sparse_moe tensors)
    raises, naming the router it could not find (MoE checkpoints convert:
    tests/test_torch_moe.py)."""
    cfg, params = tiny
    with pytest.raises(KeyError, match="block_sparse_moe.gate"):
        convert.params_from_state_dict(hf_state_dict_from_params(params), dataclasses.replace(cfg, num_local_experts=4),
                                       device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_npz_roundtrip(tmp_path, tiny, dtype):
    cfg, params = tiny
    params = {k: [{n: t.to(dtype) for n, t in layer.items()} for layer in v] if k == "layers" else v.to(dtype)
              for k, v in params.items()}
    path = os.path.join(tmp_path, "params.npz")
    convert.save_params_npz(params, path)
    loaded = convert.load_params_npz(path, cfg, device="cpu")
    assert_params_equal(loaded, params)
    assert loaded["layers"][0]["wq"].dtype == dtype


@pytest.mark.parametrize("st_dtype", ["F32", "BF16"])
def test_load_hf_model_matches_jax(tmp_path, st_dtype):
    """One synthetic checkpoint (the JAX package's writer) through both
    packages' load_hf_model with the same gates: the port's weights equal
    JAX's bitwise, in the port's [out, in] layout, and so do the head counts."""
    jcfg = dataclasses.replace(JPRESETS["tiny-gqa"], num_layers=3)
    ckpt = write_synth_checkpoint(str(tmp_path), jcfg, seed=5, dtype=st_dtype)
    gates = (np.random.default_rng(2).uniform(size=(3, jcfg.num_kv_heads)) > 0.5).astype(float)
    kw = dict(sink_size=16, recent_size=32, max_cache_size=256, prefill_chunk_size=64)
    jdtype, tdtype = (jnp.float32, torch.float32) if st_dtype == "F32" else (jnp.bfloat16, torch.bfloat16)
    jp, jcfg2, jduo = jconvert.load_hf_model(ckpt, gates, dtype=jdtype, **kw)
    tp, tcfg2, tduo = convert.load_hf_model(ckpt, gates, dtype=tdtype, device="cpu", **kw)
    assert tduo.num_full_kv_heads == jduo.num_full_kv_heads
    assert tcfg2.hidden_size == jcfg2.hidden_size and tcfg2.num_layers == 3
    as_f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    tree = {k: ([{n: as_f32(a) for n, a in layer.items()} for layer in v] if k == "layers" else as_f32(v))
            for k, v in jp.items()}
    want = params_from_numpy(tree, "cpu", torch.float32)
    got = {k: ([{n: t.float() for n, t in layer.items()} for layer in v] if k == "layers" else v.float())
           for k, v in tp.items()}
    assert_params_equal(got, want)
    assert all(t.dtype == tdtype for layer in tp["layers"] for t in layer.values())


@pytest.mark.slow
def test_convert_real_8b_geometry(tmp_path):
    """The converter at the real Llama-3-8B widths (2 layers): synthetic bf16
    checkpoint -> load_hf_model with the repo's pattern -> full-attention
    symmetry against an identity-order load -> W8A8 + INT4 decode on the CPU."""
    from duo_attention_tpu_torch import DuoEngine, load_attn_pattern, sparsify_attention_heads

    layers = 2
    ckpt = write_synth_checkpoint(str(tmp_path / "synth8b"),
                                  dataclasses.replace(JPRESETS["Llama-3-8B-Instruct-Gradient-1048k"],
                                                      num_layers=layers), seed=3)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    heads, _, _ = load_attn_pattern(os.path.join(repo, "artifacts", "niah_8b", "pattern"))
    binary = sparsify_attention_heads(heads, sparsity=0.5)[0][:layers]
    params, cfg, duo = convert.load_hf_model(ckpt, binary, sink_size=64, recent_size=256, max_cache_size=2048,
                                             prefill_chunk_size=512, device="cpu")
    assert cfg.hidden_size == 4096 and cfg.num_heads == 32 and cfg.num_kv_heads == 8
    assert cfg.vocab_size == 128256
    assert params["layers"][0]["wq"].shape == (4096, 4096) and params["layers"][0]["wk"].shape == (1024, 4096)
    assert duo.num_full_kv_heads == tuple(int(r.sum()) for r in binary)
    ids = torch.as_tensor(np.arange(24)[None] * 977 % cfg.vocab_size)
    identity, _, _ = convert.load_hf_model(ckpt, np.ones_like(binary), sink_size=64, recent_size=256,
                                           device="cpu")
    torch.testing.assert_close(llama.forward_full_attention(params, cfg, ids).float(),
                               llama.forward_full_attention(identity, cfg, ids).float(), atol=3e-2, rtol=3e-2)
    del identity
    qparams = quant.quantize_embeddings_int8(quant.quantize_params_w8a8(params))
    eng = DuoEngine(qparams, cfg, duo, device="cpu", kv_quant="int4")
    toks, cache = eng.generate(ids[:, :16].numpy(), max_new_tokens=2)
    assert toks.shape == (1, 2) and int(cache.length) == 18 and (toks >= 0).all()


# --- the gather: tests/test_native.py, on the port's index_select -------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
@pytest.mark.parametrize("shape", [(64, 64), (257, 129), (1000, 48)])
def test_gather_matches_numpy(dtype, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(dtype)
    perm = rng.permutation(shape[0])
    np.testing.assert_array_equal(convert._gathered(x).numpy(), x)
    np.testing.assert_array_equal(convert._gathered(x, perm).numpy(), x[perm])


def test_gather_bf16_bitpattern():
    x = torch.randn(300, 200).bfloat16().view(torch.int16).numpy().view(convert.BF16)
    perm = np.random.default_rng(1).permutation(300)
    got = convert._gathered(x, perm)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), x[perm].view(np.uint16))


def test_gather_with_col_perm():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((96, 128)).astype(np.float32)
    cperm = rng.permutation(128)
    np.testing.assert_array_equal(convert._gathered(x, col_perm=cperm).numpy(), x[:, cperm])


def test_gather_with_both_perms():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((70, 90)).astype(np.float16)
    perm, cperm = rng.permutation(70), rng.permutation(90)
    np.testing.assert_array_equal(convert._gathered(x, perm=perm, col_perm=cperm).numpy(), x[perm][:, cperm])


def test_loaded_params_do_not_alias_the_checkpoint(tmp_path, tiny):
    """Every param is a copy of its own, also where no permutation moved it
    and the dtype stays: none points into the read-only mmap."""
    cfg, params = tiny
    write_hf_dir(tmp_path, params, cfg)
    state = convert._load_state_dict(str(tmp_path))
    spans = [(v.__array_interface__["data"][0], v.nbytes) for v in state.values()]
    loaded = convert.params_from_state_dict(state, cfg, torch.float32, device="cpu")
    tensors = [loaded["embed"], loaded["final_norm"], *(t for layer in loaded["layers"] for t in layer.values())]
    for t in tensors:
        ptr = t.untyped_storage().data_ptr()
        assert not any(a <= ptr < a + n for a, n in spans)
    assert_params_equal(loaded, params)


def test_gather_reads_a_read_only_mmap_quietly(tmp_path):
    """A view of a read-only mmap (as a checkpoint's) gathers with no warning."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 17)).astype(np.float32)
    path = os.path.join(tmp_path, "x.bin")
    x.tofile(path)
    view = np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)
    perm, cperm = rng.permutation(33), rng.permutation(17)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = convert._gathered(view, perm, cperm)
    np.testing.assert_array_equal(got.numpy(), x[perm][:, cperm])


def test_mmap_safetensors_roundtrip(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(4)
    tensors = {"a": torch.as_tensor(rng.standard_normal((17, 33)).astype(np.float32)),
               "b": torch.as_tensor(rng.standard_normal((8, 4, 2))).bfloat16(),
               "c": torch.as_tensor(rng.integers(0, 100, (5,)))}
    path = os.path.join(tmp_path, "model.safetensors")
    save_file(tensors, path)
    loaded = convert.mmap_safetensors(path)
    assert set(loaded) == set(tensors)
    assert loaded["a"].dtype == np.float32 and loaded["c"].dtype == np.int64
    assert convert.is_bf16(loaded["b"]) and not convert.is_bf16(loaded["a"])
    np.testing.assert_array_equal(loaded["a"], tensors["a"].numpy())
    np.testing.assert_array_equal(loaded["c"], tensors["c"].numpy())
    np.testing.assert_array_equal(loaded["b"].view(np.int16), tensors["b"].view(torch.int16).numpy())
