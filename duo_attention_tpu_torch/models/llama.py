"""Llama / Mistral / Mixtral forward over the duo split cache.

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

Gate training's forward is here too: ``forward_two_way`` (teacher and
student streams over ``ops/blockwise.py``, optionally sequence-sharded with
Ulysses and with a per-layer FSDP gather hook), ``head_logits`` and
``all_logits``. ``forward_chunk`` also takes a pipeline stage's hidden
states and its params without the embedding or the final norm. A Mixtral layer's MLP is ``_moe_mlp``: JAX's dense dispatch
(every expert computes every token; the router's top-k weights pick the
sum), its experts stacked on a leading axis in the ``[out, in]`` layout and
the router ``moe_gate`` kept in JAX's ``[hidden, experts]`` float32.

Tensor parallelism (``mesh=``, ``parallel/mesh.py``): each rank holds its
slices of the params (``shard_params``) and of the cache (its KV heads of
every layer), attends with its query heads, and the step calls the
collectives itself: an all_reduce after wo in a head-sharded layer and after
the MLP's w_down (or a MoE layer's expert sum), vocab-parallel embedding and
head. With ``mesh=None`` the code path is the one-device one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..cache import DuoCache, DuoCacheQ4, write_full_pair, write_full_q4_pair, write_streaming
from ..config import DuoConfig, ModelConfig
from ..ops import flash
from ..ops.attention_ref import causal_attention_ref
from ..ops.blockwise import blockwise_attention, causal_mask_fn, lambda_mask_fn
from ..ops.norm import rms_norm
from ..ops.quant import w8a8_linear, w8a8_linear_group, w8a8_linear_row_split
from ..ops.rope import apply_rope, rope_tables
from ..parallel import spmd
from ..parallel.mesh import all_reduce, plan_for, sum_across, vocab_shard
from ..parallel.ulysses import ulysses_attention
from ..utils import resolve_device

Params = Dict[str, Any]
Cache = Union[DuoCache, DuoCacheQ4]


def _dense(gen, dev, dtype, out_f, in_f, scale=None):
    w = torch.randn((out_f, in_f), generator=gen, device=dev, dtype=torch.float32)
    return w.mul_(in_f**-0.5 if scale is None else scale).to(dtype)


def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype, dev) -> Params:
    """One decoder layer's random params, drawn from ``gen`` on ``dev``. A
    MoE layer (``cfg.num_local_experts`` X > 0) has the router ``moe_gate``
    [E, X] float32 and the experts ``experts_w_gate`` / ``experts_w_up``
    [X, I, E] and ``experts_w_down`` [X, E, I] in place of the dense MLP."""
    E, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    layer = {
        "input_norm": torch.ones(E, dtype=dtype, device=dev),
        "post_norm": torch.ones(E, dtype=dtype, device=dev),
        "wq": _dense(gen, dev, dtype, Hq * D, E),
        "wk": _dense(gen, dev, dtype, Hkv * D, E),
        "wv": _dense(gen, dev, dtype, Hkv * D, E),
        "wo": _dense(gen, dev, dtype, E, Hq * D),
    }
    X = cfg.num_local_experts
    if X > 0:
        layer["moe_gate"] = _dense(gen, dev, torch.float32, E, X, scale=E**-0.5)  # [E, X], as JAX's
        for name, (out_f, in_f) in (("experts_w_gate", (I, E)), ("experts_w_up", (I, E)),
                                    ("experts_w_down", (E, I))):
            layer[name] = torch.stack([_dense(gen, dev, dtype, out_f, in_f) for _ in range(X)])
    else:
        layer["w_gate"] = _dense(gen, dev, dtype, I, E)
        layer["w_up"] = _dense(gen, dev, dtype, I, E)
        layer["w_down"] = _dense(gen, dev, dtype, E, I)
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


def _keep(li, part):
    return part


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda", shard=None) -> Params:
    """Random params with the model's shapes, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (normal, scaled 1/sqrt(fan_in);
    embeddings 0.02; norms 1). Raises when device is "cuda" and no GPU is
    present. ``shard(layer index or None, part) -> part`` is applied to each
    layer, and to the top (None), as soon as it is drawn
    (``parallel.mesh.sharder``: a rank keeps its slices and never holds the
    whole model); the draws are the same with or without it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shard = shard or _keep
    layers = [shard(li, init_layer(cfg, gen, dtype, dev)) for li in range(cfg.num_layers)]
    params = shard(None, init_top(cfg, gen, dtype, dev))
    params["layers"] = layers
    return params


def lm_head_weight(params: Params) -> torch.Tensor:
    """[vocab, E]: the lm head, or the embedding table when tied."""
    return params["lm_head"] if "lm_head" in params else params["embed"]


def embed_lookup(params: Params, input_ids: torch.Tensor, mesh=None, cfg: Optional[ModelConfig] = None
                 ) -> torch.Tensor:
    """Embedding gather; int8 rows are dequantized per row, into the dtype of
    the first layer's input norm. Under a mesh whose tensor axis splits the
    vocab (``cfg`` given), the rank looks up its rows, zeroes the ids outside
    them, and the ranks' lookups are summed (exact)."""
    if mesh is not None:
        split, start, rows = vocab_shard(mesh, cfg)
        if split:
            local = input_ids - start
            inside = (local >= 0) & (local < rows)
            x = embed_lookup(params, torch.where(inside, local, 0))
            return sum_across(mesh, x.masked_fill(~inside[..., None], 0))
    if "embed_q8" in params:
        rows = F.embedding(input_ids, params["embed_q8"]).float()
        scale = params["embed_scale"][input_ids][..., None]
        return (rows * scale).to(params["layers"][0]["input_norm"].dtype)
    return F.embedding(input_ids, params["embed"])


def _head_logits(params: Params, h: torch.Tensor, plain: bool = False, mesh=None,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """h [..., E] -> logits [..., vocab] float32. An int8 head (or, with tied
    embeddings, the int8 table, whose per-row scale is then the head's
    per-out-channel scale) runs as a W8A8 linear with float32 output; a
    high-precision head is computed in h's dtype. Under a mesh whose tensor
    axis splits the vocab (``cfg`` given), the rank computes its vocab slice,
    placed in a zero [..., vocab] float32 tensor, and the ranks' tensors are
    summed (exact): every rank gets the whole logits."""
    if mesh is not None:
        split, start, rows = vocab_shard(mesh, cfg)
        if split:
            local = _head_logits(params, h, plain)
            full = local.new_zeros((*local.shape[:-1], rows * mesh.tensor))
            full[..., start : start + rows] = local
            return all_reduce(mesh, full)
    if "lm_head_q8" in params:
        return w8a8_linear(h, params["lm_head_q8"], params["lm_head_scale"], torch.float32, plain)
    if "embed_q8" in params and "lm_head" not in params:
        return w8a8_linear(h, params["embed_q8"], params["embed_scale"], torch.float32, plain)
    return F.linear(h, lm_head_weight(params)).float()


def head_logits(params: Params, h: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The lm head over every position: hidden [..., E] -> logits [...,
    vocab] float32 (pretraining and the eval oracles)."""
    return _head_logits(params, h, plain)


def all_logits(params: Params, hidden: torch.Tensor, plain: bool = False) -> torch.Tensor:
    return _head_logits(params, hidden, plain)


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


def _row_proj(layer: Params, x: torch.Tensor, name: str, plain: bool = False, mesh=None) -> torch.Tensor:
    """``_proj`` of a projection whose input dimension is split over the
    mesh's tensor ranks (wo, w_down): the partial products are summed over
    the ranks (W8A8: ``w8a8_linear_row_split``). ``_proj`` when mesh is None."""
    if mesh is None:
        return _proj(layer, x, name, plain)
    if name + "_q8" in layer:
        return w8a8_linear_row_split(x, layer[name + "_q8"], layer[name + "_scale"], mesh, x.dtype, plain)
    return sum_across(mesh, F.linear(x, layer[name]))


def _qkv(layer: Params, x: torch.Tensor, cfg: ModelConfig, plain: bool = False):
    """q, k, v [B, S, heads, D] of the heads whose projections ``layer``
    holds (a rank's heads under tensor parallelism)."""
    B, S, _ = x.shape
    D = cfg.head_dim
    q, k, v = _proj_group(layer, x, ("wq", "wk", "wv"), plain)
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q.reshape(B, S, -1, D), k.reshape(B, S, -1, D), v.reshape(B, S, -1, D)


def _mlp(layer: Params, x: torch.Tensor, cfg: ModelConfig, plain: bool = False, mesh=None) -> torch.Tensor:
    """The MLP; with ``mesh`` the rank's split of it (megatron rows and
    columns, or its experts), summed over the tensor ranks."""
    if "moe_gate" in layer:
        return _moe_mlp(layer, x, cfg.num_experts_per_tok, mesh)
    gate, up = _proj_group(layer, x, ("w_gate", "w_up"), plain)
    hidden = F.silu(gate).mul_(up)  # in place: gate and up are both alive here
    del gate, up  # freed before the down projection's activations are made
    return _row_proj(layer, hidden, "w_down", plain, mesh)


def moe_router(layer: Params, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """The Mixtral router: float32 logits x @ moe_gate [.., X], their top-k,
    a softmax over the chosen logits, scattered into ``combine`` [..., X]
    (zero for the experts a token does not pick)."""
    logits = x.float() @ layer["moe_gate"].float()
    topv, topi = torch.topk(logits, top_k, dim=-1)
    return torch.zeros_like(logits).scatter_(-1, topi, torch.softmax(topv, dim=-1))


def _moe_mlp(layer: Params, x: torch.Tensor, top_k: int, mesh=None) -> torch.Tensor:
    """Mixtral sparse-MoE MLP with JAX's dense dispatch: every expert
    computes every token (SwiGLU on the stacked leading axis, in x's dtype)
    and the result is the sum over experts of each output times its
    ``combine`` weight, cast to x's dtype as JAX casts it. The step's shapes
    do not depend on the routing, so a decode step stays capturable. The
    expert products are plain torch, as JAX's are plain XLA: gate and up one
    product each over the experts side by side (the stacked weights read in
    place as [X * I, E]), down one batched product over the experts.

    With ``mesh`` (expert parallelism) the layer holds the rank's experts,
    the router (replicated) still routes over all of them, and the rank's
    partial sum, taken in float32, is summed over the tensor ranks."""
    B, S, E = x.shape
    dt = x.dtype
    combine = moe_router(layer, x, top_k).to(dt).reshape(B * S, -1).t()  # [X, B*S]
    if mesh is not None:
        X = layer["experts_w_gate"].shape[0]
        combine = combine[mesh.tensor_rank * X : (mesh.tensor_rank + 1) * X]
    X = combine.shape[0]
    gate = F.linear(x, layer["experts_w_gate"].to(dt).reshape(-1, E)).view(B * S, X, -1)
    up = F.linear(x, layer["experts_w_up"].to(dt).reshape(-1, E)).view(B * S, X, -1)
    act = F.silu(gate).mul_(up)  # [B*S, X, I]
    del gate, up
    out = torch.bmm(act.transpose(0, 1), layer["experts_w_down"].to(dt).transpose(1, 2))  # [X, B*S, E]
    if mesh is not None:
        part = (out * combine[..., None]).sum(dim=0, dtype=torch.float32)
        return all_reduce(mesh, part).to(dt).view(B, S, E)
    return (out * combine[..., None]).sum(dim=0).view(B, S, E)


def _duo_layer_attention(layer_idx: int, q, k, v, cache: Cache, cfg: ModelConfig,
                         duo: DuoConfig, write_start, full_bucket: int, plain: bool, shard=None, mesh=None,
                         valid=None):
    """Split-head attention of one layer; writes this chunk's K/V into the
    layer's cache buffers first (in place).

    q [B, S, Hq, D]; k/v [B, S, Hkv, D], post-RoPE. The first hf*G query
    heads and hf KV heads are retrieval heads, the rest streaming heads.
    write_start: the chunk's first position (an int for S > 1; the length
    tensor for decode). valid: the [B] real queries of a decode step's rows
    (None: every row); the bf16 full heads read no key of a row with none,
    whose output is then 0. ``plain`` runs every op's plain PyTorch version
    whatever the device — the reference path the kernels are held against.
    With a ``DuoCacheQ4`` the full heads are quantized to INT4 on the way in
    and attended through ``full_cache_attention_q4``. Under tensor
    parallelism ``shard`` (a ``parallel.mesh.LayerShard``) gives the rank's
    KV heads, which q/k/v and the cache hold; a head-sharded layer attends
    through ``parallel/spmd.py`` (``mesh`` given), a replicated one as here.
    """
    if shard is None:
        hf = duo.num_full_kv_heads[layer_idx]
        hs = cfg.num_kv_heads - hf
    else:
        hf, hs = shard.hf, shard.hs
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
            if mesh is not None:
                outs.append(spmd.sharded_full_attention_q4(mesh, q_f, kq, ks, vq, vs, cs, bucket=full_bucket,
                                                           plain=plain))
            else:
                attn = flash.full_cache_attention_q4_plain if plain else flash.full_cache_attention_q4
                outs.append(attn(q_f, kq, ks, vq, vs, cs, bucket=full_bucket))
        else:
            # one launch for both rows at decode, read in place from the views
            kf, vf = write_full_pair(cache.k_full[layer_idx], cache.v_full[layer_idx], k_in, v_in,
                                     write_start, plain)
            if mesh is not None:
                outs.append(spmd.sharded_full_attention(mesh, q_f, kf, vf, cs, bucket=full_bucket, plain=plain,
                                                        valid=valid))
            else:
                attn = flash.full_cache_attention_plain if plain else flash.full_cache_attention
                outs.append(attn(q_f, kf, vf, cs, bucket=full_bucket, valid=valid))
    if hs > 0:
        bufs = write_streaming(
            cache.k_sink[layer_idx], cache.v_sink[layer_idx],
            cache.k_ring[layer_idx], cache.v_ring[layer_idx],
            k[:, :, hf:].transpose(1, 2), v[:, :, hf:].transpose(1, 2),  # views, read in place
            write_start, duo.sink_size, plain,
        )
        # total_after counts the chunk's padding too; the masks hide it
        if mesh is not None:
            outs.append(spmd.sharded_streaming_attention(mesh, q[:, :, hf * G :].contiguous(), *bufs, cs, cs + S,
                                                         duo.sink_size, duo.recent_size, plain=plain))
        else:
            attn = flash.streaming_cache_attention_plain if plain else flash.streaming_cache_attention
            outs.append(attn(q[:, :, hf * G :].contiguous(), *bufs, cs, cs + S,
                             duo.sink_size, duo.recent_size))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def forward_chunk(params: Params, cfg: ModelConfig, duo: DuoConfig, cache: Cache,
                  input_ids: torch.Tensor, n_valid: Optional[int] = None,
                  full_bucket: int = 0, plain: bool = False, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """One forward step over a chunk of tokens, updating the cache in place.

    input_ids [B, S] on the cache's device (the tail past n_valid is
    padding, written to the cache and overwritten later as in JAX), or the
    hidden states [B, S, E] a pipeline stage after the first is fed
    (``parallel/pipeline.py``): the embedding lookup is skipped. The final
    norm is applied only when ``params`` holds ``final_norm`` (a stage before
    the last emits the raw residual stream).
    full_bucket: a bound >= length + S on the full-cache slots the attention
    reads (0: the whole buffer). Returns (hidden [B, S, E] after the final
    norm, cache) with ``cache.length`` advanced by n_valid (default S) in
    place. A decode step (S == 1) reads nothing back to the host, so it can
    be captured into a CUDA graph and replayed (``engine.DuoEngine``).

    ``mesh``: a ``parallel.mesh.Mesh``; params and cache are then the
    rank's (``shard_params``, ``cache_shardings``) and every rank of the
    tensor group must make the same call. The hidden states come back whole
    on every rank.
    """
    B, S = input_ids.shape[:2]
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
    # a decode step's [B] n_valid (the serving pool's active rows): the full heads skip the rows with none
    valid = n_valid if S == 1 and torch.is_tensor(n_valid) and n_valid.dim() == 1 else None

    plan = None if mesh is None else plan_for(mesh, cfg, duo)
    x = embed_lookup(params, input_ids, mesh, cfg) if input_ids.dim() == 2 else input_ids
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, h, cfg, plain)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if plan is None:
            attn = _duo_layer_attention(li, q, k, v, cache, cfg, duo, write_start, full_bucket, plain, valid=valid)
            x = x + _proj(layer, attn.reshape(B, S, cfg.num_heads * cfg.head_dim), "wo", plain)
            x = x + _mlp(layer, rms_norm(x, layer["post_norm"], cfg.rms_norm_eps), cfg, plain)
            continue
        s = plan.layers[li]
        sharded = mesh if s.sharded else None  # a replicated layer's attention needs no collective
        attn = _duo_layer_attention(li, q, k, v, cache, cfg, duo, write_start, full_bucket, plain, s, sharded,
                                    valid)
        x = x + _row_proj(layer, attn.reshape(B, S, -1), "wo", plain, sharded)
        x = x + _mlp(layer, rms_norm(x, layer["post_norm"], cfg.rms_norm_eps), cfg, plain, mesh if s.mlp else None)
    if "final_norm" in params:
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    cache.length.add_(n_valid)  # in place: a replayed decode step advances it too
    return x, cache


def logits_at(params: Params, hidden: torch.Tensor, index: int, plain: bool = False, mesh=None,
              cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """lm head on one position: hidden [B, S, E] -> [B, vocab] float32.
    Under a mesh (``cfg`` given) the whole logits on every rank."""
    return _head_logits(params, hidden[:, index], plain, mesh, cfg)


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
        x = x + _mlp(layer, rms_norm(x, layer["post_norm"], cfg.rms_norm_eps), cfg)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# Two-way forward (gate training)
# ---------------------------------------------------------------------------


def clip_gates(gates: torch.Tensor) -> torch.Tensor:
    """Gates clipped to [0, 1] with JAX's ``jnp.clip`` gradient: full inside,
    0 outside and one half exactly on a bound, where ``torch.maximum`` and
    ``torch.minimum`` split the tie as ``lax.max`` and ``lax.min`` do
    (``torch.clamp`` passes the whole gradient there). The gates sit on a
    bound at the start (1) and once pruned (0)."""
    zero = torch.zeros((), dtype=gates.dtype, device=gates.device)
    return torch.minimum(torch.maximum(gates, zero), zero + 1)


def forward_two_way(params: Params, gates: torch.Tensor, cfg: ModelConfig, sink_size: int, recent_size: int,
                    input_ids: torch.Tensor, seq_axis=None, block_k: int = 512, layer_hook=None,
                    remat: bool = False, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher and student streams of gate identification (counterpart of
    duo_attention_tpu/models/llama.py ``forward_two_way``).

    The teacher runs full causal attention under ``torch.no_grad()``: it
    does not depend on the gates, and each layer's attention output
    ``full_out`` [B, S, Hq, D] is kept for the student, so the teacher is
    never recomputed (JAX's ``stop_gradient`` computes the same values). The
    student runs Λ-masked streaming attention on its own hidden states and
    mixes each query head as (1 - α)·stream + α·full_out in float32, α the
    clipped gate of the head's KV head. Only ``gates`` [num_layers,
    num_kv_heads] float32 gets a gradient. ``remat=True`` puts each student
    layer under ``torch.utils.checkpoint``: the backward recomputes its
    forward. Attention is ``ops/blockwise.py`` (its blocks recomputed in the
    backward too). ``plain`` runs the plain version of every kernel.

    ``seq_axis`` (a mesh's seq axis, ``Mesh.axis("seq")``): input_ids are the
    rank's sequence shard, its positions offset by seq rank x S, and both
    attentions run under Ulysses resharding (``parallel/ulysses.py``), as
    the reference's UlyssesAttention wrap (duo_attn/patch/llama.py:492-501);
    every rank of the axis makes the same call.

    ``layer_hook(layer, (ht, hs)) -> (layer, (ht, hs))`` is called at the top
    of each layer (FSDP: ``parallel/fsdp.py::make_gather_hook`` gathers the
    layer's sharded weights). Its layer serves the teacher and, without
    remat, the student; with remat the student's checkpointed block calls the
    hook itself, so its backward gathers the layer again instead of keeping
    it (JAX runs the hook inside its remat'd block), and each gathered copy
    is dropped after its use.

    Returns (teacher_hidden, student_hidden), both after the final norm,
    [B, S, E]; the teacher's is detached."""
    B, S = input_ids.shape
    offset = 0 if seq_axis is None else seq_axis.rank * S
    positions = offset + torch.arange(S, dtype=torch.int32, device=input_ids.device)
    cos, sin = rope_tables(cfg, positions)
    cos, sin = cos[None], sin[None]
    lam = lambda_mask_fn(sink_size, recent_size)
    G = cfg.num_kv_groups

    def attend(q, k, v, mask_fn):
        fn = lambda q, k, v: blockwise_attention(q, k, v, mask_fn, block_k=block_k)  # noqa: E731
        return fn(q, k, v) if seq_axis is None else ulysses_attention(fn, q, k, v, seq_axis)

    def attention_in(layer, h):
        q, k, v = _qkv(layer, rms_norm(h, layer["input_norm"], cfg.rms_norm_eps), cfg, plain)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def block_out(layer, h, attn):
        h = h + _proj(layer, attn.reshape(B, S, -1), "wo", plain)
        return h + _mlp(layer, rms_norm(h, layer["post_norm"], cfg.rms_norm_eps), cfg, plain)

    def student(layer, alpha_raw, hs, full_out):
        alpha_q = clip_gates(alpha_raw).float().repeat_interleave(G).reshape(1, 1, cfg.num_heads, 1)
        stream_out = attend(*attention_in(layer, hs), lam)
        mixed = (1.0 - alpha_q) * stream_out.float() + alpha_q * full_out.float()
        return block_out(layer, hs, mixed.to(stream_out.dtype))

    def student_gathered(layer, alpha_raw, hs, full_out):
        return student(layer_hook(layer, (None, hs))[0], alpha_raw, hs, full_out)

    ht = hs = embed_lookup(params, input_ids)
    for li, layer in enumerate(params["layers"]):
        used = layer
        if layer_hook is not None:
            used, (ht, hs) = layer_hook(layer, (ht, hs))
        with torch.no_grad():
            full_out = attend(*attention_in(used, ht), causal_mask_fn)
            ht = block_out(used, ht, full_out)
        if remat and torch.is_grad_enabled():
            if layer_hook is not None:
                del used  # the student's block gathers its own copy, forward and backward
                hs = checkpoint(student_gathered, layer, gates[li], hs, full_out, use_reentrant=False)
            else:
                hs = checkpoint(student, layer, gates[li], hs, full_out, use_reentrant=False)
        else:
            hs = student(used, gates[li], hs, full_out)
            del used
    ht = rms_norm(ht, params["final_norm"], cfg.rms_norm_eps)
    hs = rms_norm(hs, params["final_norm"], cfg.rms_norm_eps)
    return ht.detach(), hs
