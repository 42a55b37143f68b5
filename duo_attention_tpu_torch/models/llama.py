"""Llama / Mistral (dense) forward over the duo split cache.

Counterpart of duo_attention_tpu/models/llama.py for the main path in both
formats (bf16 over ``DuoCache``; W8A8 weights over the INT4 ``DuoCacheQ4``):
random init, chunked prefill and decode (``forward_chunk``), the last-token
lm head and the uncached full-attention oracle. Params are a plain dict of
tensors with the JAX package's structure; projections use PyTorch's
``[out_features, in_features]`` layout (``F.linear``), so
``models/from_jax.py`` transposes the JAX ``[in, out]`` weights. A projection
named ``w`` runs as a W8A8 linear when the layer holds ``w_q8`` and
``w_scale`` instead. KV heads are assumed already reordered (retrieval heads
first), as in the JAX package.

Not ported yet: MoE MLPs, meshes and the two-way training forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..cache import DuoCache, DuoCacheQ4, write_full_pair, write_full_q4_pair, write_streaming
from ..config import DuoConfig, ModelConfig
from ..ops import flash
from ..ops.attention_ref import causal_attention_ref
from ..ops.norm import rms_norm
from ..ops.quant import w8a8_linear, w8a8_linear_group
from ..ops.rope import apply_rope, rope_tables
from ..utils import resolve_device

Params = Dict[str, Any]
Cache = Union[DuoCache, DuoCacheQ4]


def _dense(gen, dev, dtype, out_f, in_f, scale=None):
    w = torch.randn((out_f, in_f), generator=gen, device=dev, dtype=torch.float32)
    return w.mul_(in_f**-0.5 if scale is None else scale).to(dtype)


def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype, dev) -> Params:
    """One decoder layer's random params, drawn from ``gen`` on ``dev``."""
    if cfg.num_local_experts > 0:
        raise NotImplementedError("MoE MLPs are not ported yet")
    E, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    layer = {
        "input_norm": torch.ones(E, dtype=dtype, device=dev),
        "post_norm": torch.ones(E, dtype=dtype, device=dev),
        "wq": _dense(gen, dev, dtype, Hq * D, E),
        "wk": _dense(gen, dev, dtype, Hkv * D, E),
        "wv": _dense(gen, dev, dtype, Hkv * D, E),
        "wo": _dense(gen, dev, dtype, E, Hq * D),
        "w_gate": _dense(gen, dev, dtype, I, E),
        "w_up": _dense(gen, dev, dtype, I, E),
        "w_down": _dense(gen, dev, dtype, E, I),
    }
    if cfg.attention_bias:
        for name, n in (("bq", Hq * D), ("bk", Hkv * D), ("bv", Hkv * D)):
            layer[name] = torch.zeros(n, dtype=dtype, device=dev)
    return layer


def init_top(cfg: ModelConfig, gen: torch.Generator, dtype, dev) -> Params:
    """The params outside the layers: embed, final_norm and, unless tied, lm_head."""
    E = cfg.hidden_size
    top = {
        "embed": _dense(gen, dev, dtype, cfg.vocab_size, E, scale=0.02),
        "final_norm": torch.ones(E, dtype=dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        top["lm_head"] = _dense(gen, dev, dtype, cfg.vocab_size, E)
    return top


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> Params:
    """Random params with the model's shapes, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (normal, scaled 1/sqrt(fan_in);
    embeddings 0.02; norms 1). Raises when device is "cuda" and no GPU is
    present."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = [init_layer(cfg, gen, dtype, dev) for _ in range(cfg.num_layers)]
    params = init_top(cfg, gen, dtype, dev)
    params["layers"] = layers
    return params


def lm_head_weight(params: Params) -> torch.Tensor:
    """[vocab, E]: the lm head, or the embedding table when tied."""
    return params["lm_head"] if "lm_head" in params else params["embed"]


def embed_lookup(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather; int8 rows are dequantized per row, into the dtype of
    the first layer's input norm."""
    if "embed_q8" in params:
        rows = F.embedding(input_ids, params["embed_q8"]).float()
        scale = params["embed_scale"][input_ids][..., None]
        return (rows * scale).to(params["layers"][0]["input_norm"].dtype)
    return F.embedding(input_ids, params["embed"])


def _head_logits(params: Params, h: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """h [..., E] -> logits [..., vocab] float32. An int8 head (or, with tied
    embeddings, the int8 table, whose per-row scale is then the head's
    per-out-channel scale) runs as a W8A8 linear with float32 output; a
    high-precision head is computed in h's dtype."""
    if "lm_head_q8" in params:
        return w8a8_linear(h, params["lm_head_q8"], params["lm_head_scale"], torch.float32, plain)
    if "embed_q8" in params and "lm_head" not in params:
        return w8a8_linear(h, params["embed_q8"], params["embed_scale"], torch.float32, plain)
    return F.linear(h, lm_head_weight(params)).float()


def _proj(layer: Params, x: torch.Tensor, name: str, plain: bool = False) -> torch.Tensor:
    """bf16 or W8A8 projection, chosen by which params the layer holds."""
    if name + "_q8" in layer:
        return w8a8_linear(x, layer[name + "_q8"], layer[name + "_scale"], x.dtype, plain)
    return F.linear(x, layer[name])


def _proj_group(layer: Params, x: torch.Tensor, names, plain: bool = False):
    """The projections ``names`` of one input x: when all are W8A8, one
    ``w8a8_linear_group`` (x quantized once; one kernel launch at decode)."""
    if all(name + "_q8" in layer for name in names):
        weights = [(layer[name + "_q8"], layer[name + "_scale"]) for name in names]
        return w8a8_linear_group(x, weights, x.dtype, plain)
    return tuple(_proj(layer, x, name, plain) for name in names)


def _qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig, plain: bool = False):
    B, S, _ = x.shape
    D = cfg.head_dim
    q, k, v = _proj_group(layer, x, ("wq", "wk", "wv"), plain)
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return (q.reshape(B, S, cfg.num_heads, D), k.reshape(B, S, cfg.num_kv_heads, D),
            v.reshape(B, S, cfg.num_kv_heads, D))


def _mlp(layer: Params, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    if "moe_gate" in layer:
        raise NotImplementedError("MoE MLPs are not ported yet")
    gate, up = _proj_group(layer, x, ("w_gate", "w_up"), plain)
    hidden = F.silu(gate).mul_(up)  # in place: gate and up are both alive here
    del gate, up  # freed before the down projection's activations are made
    return _proj(layer, hidden, "w_down", plain)


def _duo_layer_attention(layer_idx: int, q, k, v, cache: Cache, cfg: ModelConfig,
                         duo: DuoConfig, write_start, full_bucket: int, plain: bool):
    """Split-head attention of one layer; writes this chunk's K/V into the
    layer's cache buffers first (in place).

    q [B, S, Hq, D]; k/v [B, S, Hkv, D], post-RoPE. The first hf*G query
    heads and hf KV heads are retrieval heads, the rest streaming heads.
    write_start: the chunk's first position (an int for S > 1; the length
    tensor for decode). ``plain`` runs every op's plain PyTorch version
    whatever the device — the reference path the kernels are held against.
    With a ``DuoCacheQ4`` the full heads are quantized to INT4 on the way in
    and attended through ``full_cache_attention_q4``.
    """
    hf = duo.num_full_kv_heads[layer_idx]
    hs = cfg.num_kv_heads - hf
    G = cfg.num_kv_groups
    S = q.shape[1]
    cs = cache.length
    outs = []
    if hf > 0:
        k_in, v_in = k[:, :, :hf].transpose(1, 2), v[:, :, :hf].transpose(1, 2)  # views, [B, hf, S, D]
        q_f = q[:, :, : hf * G].contiguous()
        if isinstance(cache, DuoCacheQ4):
            # one launch for both rows at decode, read in place from the views
            kq, ks, vq, vs = write_full_q4_pair(cache.k_full_q[layer_idx], cache.k_full_s[layer_idx],
                                                cache.v_full_q[layer_idx], cache.v_full_s[layer_idx],
                                                k_in, v_in, write_start, plain)
            attn = flash.full_cache_attention_q4_plain if plain else flash.full_cache_attention_q4
            outs.append(attn(q_f, kq, ks, vq, vs, cs, bucket=full_bucket))
        else:
            # one launch for both rows at decode, read in place from the views
            kf, vf = write_full_pair(cache.k_full[layer_idx], cache.v_full[layer_idx], k_in, v_in,
                                     write_start, plain)
            attn = flash.full_cache_attention_plain if plain else flash.full_cache_attention
            outs.append(attn(q_f, kf, vf, cs, bucket=full_bucket))
    if hs > 0:
        bufs = write_streaming(
            cache.k_sink[layer_idx], cache.v_sink[layer_idx],
            cache.k_ring[layer_idx], cache.v_ring[layer_idx],
            k[:, :, hf:].transpose(1, 2), v[:, :, hf:].transpose(1, 2),  # views, read in place
            write_start, duo.sink_size, plain,
        )
        attn = flash.streaming_cache_attention_plain if plain else flash.streaming_cache_attention
        # total_after counts the chunk's padding too; the masks hide it
        outs.append(attn(q[:, :, hf * G :].contiguous(), *bufs, cs, cs + S,
                         duo.sink_size, duo.recent_size))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def forward_chunk(params: Params, cfg: ModelConfig, duo: DuoConfig, cache: Cache,
                  input_ids: torch.Tensor, n_valid: Optional[int] = None,
                  full_bucket: int = 0, plain: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One forward step over a chunk of tokens, updating the cache in place.

    input_ids [B, S] on the cache's device (the tail past n_valid is
    padding, written to the cache and overwritten later as in JAX).
    full_bucket: a bound >= length + S on the full-cache slots the attention
    reads (0: the whole buffer). Returns (hidden [B, S, E] after the final
    norm, cache) with ``cache.length`` advanced by n_valid (default S) in
    place. A decode step (S == 1) reads nothing back to the host, so it can
    be captured into a CUDA graph and replayed (``engine.DuoEngine``).
    """
    B, S = input_ids.shape
    if n_valid is None:
        n_valid = S
    arange = torch.arange(S, dtype=torch.int32, device=input_ids.device)
    if cache.length.dim() == 1:  # per-sequence lengths
        positions = cache.length[:, None] + arange
    else:
        positions = cache.length + arange
    cos, sin = rope_tables(cfg, positions)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    # Prefill writes slice the buffers at the chunk start (one host read per
    # chunk); decode writes read the length on the device.
    if S > 1 and cache.length.dim() != 0:
        raise ValueError("ragged prefill is unsupported: a chunk needs one scalar cache length")
    write_start = int(cache.length) if S > 1 else cache.length

    x = embed_lookup(params, input_ids)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, h, cfg, plain)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = _duo_layer_attention(li, q, k, v, cache, cfg, duo, write_start, full_bucket, plain)
        x = x + _proj(layer, attn.reshape(B, S, cfg.num_heads * cfg.head_dim), "wo", plain)
        x = x + _mlp(layer, rms_norm(x, layer["post_norm"], cfg.rms_norm_eps), plain)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    cache.length.add_(n_valid)  # in place: a replayed decode step advances it too
    return x, cache


def logits_at(params: Params, hidden: torch.Tensor, index: int, plain: bool = False) -> torch.Tensor:
    """lm head on one position: hidden [B, S, E] -> [B, vocab] float32."""
    return _head_logits(params, hidden[:, index], plain)


def forward_full_attention(params: Params, cfg: ModelConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """Plain causal forward with no cache: the gates = 1 oracle."""
    B, S = input_ids.shape
    positions = torch.arange(S, dtype=torch.int32, device=input_ids.device)
    cos, sin = rope_tables(cfg, positions)
    x = embed_lookup(params, input_ids)
    for layer in params["layers"]:
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, cos[None], sin[None])
        k = apply_rope(k, cos[None], sin[None])
        attn = causal_attention_ref(q, k, v)
        x = x + _proj(layer, attn.reshape(B, S, -1), "wo")
        x = x + _mlp(layer, rms_norm(x, layer["post_norm"], cfg.rms_norm_eps))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
