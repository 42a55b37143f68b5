"""Quantization ops: asymmetric per-token INT4 KV and W8A8 linears.

Counterpart of duo_attention_tpu/ops/quant.py.

* INT4 KV: asymmetric min/max per (token, head) over the head_dim channels,
  scale = (max - min) / 15 + 1e-8, zero-point = min, all in float32; the
  nibbles come from the float32 scale, and the STORED scale and zero-point
  are those values rounded to bf16. The cache keeps the token-paired layout
  (``quantize_int4_paired``): byte (r, d) = q4(token 2r, d) | q4(token
  2r+1, d) << 4, scales [..., 4, S/2] = (scale_even, scale_odd, zp_even,
  zp_odd). ``quantize_int4`` / ``dequantize_int4`` are the flat
  channel-plane layout the tests and oracles use.
* W8A8: int8 weights with per-out-channel scales, int8 activations with
  per-token dynamic scales, int8 x int8 -> int32, then
  ``(float(acc) * x_scale) * w_scale``. ``w8a8_linear_group`` takes the
  projections that share an input (wq, wk, wv; gate, up) together: on the
  card at M <= ``gemm.SMALL_M_MAX`` the small-M kernel multiplies x by each
  weight, reading each once, and quantizes x itself up to 8 rows (past them
  one launch of ``gemm.quantize_rows`` goes first; ``gemm.w8a8_small_group``);
  otherwise x is quantized once in plain torch and each product is
  ``gemm.w8a8_matmul``. Where x needs a gradient the linears are
  differentiable by JAX's straight-through estimator (``_W8A8STE``): the
  backward is that of ``x @ (wq * w_scale)``, the activation quantization
  taken as the identity. Each eager
  quantization of x in plain torch is an ``engine.quantize_act`` span
  (``tracing``) while spans are recorded; none opens inside a captured
  CUDA graph, so a replayed decode step's quantization is not a span.

Weights here are ``[out_features, in_features]`` (PyTorch's layout); the JAX
package keeps ``[in, out]``. ``models/from_jax.py`` transposes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import tracing
from ..utils import resolve_device
from .gemm import SMALL_M_MAX, w8a8_matmul, w8a8_matmul_plain, w8a8_small_group

QUANTIZED_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_constants = {}


def _const(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor ON ``device``. Dividing by it is an IEEE
    division; dividing by a Python number is, on the card, a multiplication
    by the rounded reciprocal, which differs in the last bit and would break
    the bitwise agreement with the CUDA kernels and with the JAX package."""
    key = (value, str(device))
    if key not in _constants:
        _constants[key] = torch.full((), value, dtype=torch.float32, device=device)
    return _constants[key]


# ---------------------------------------------------------------------------
# INT4 KV
# ---------------------------------------------------------------------------


def quantize_int4_nibbles(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., T, D] -> (nibbles [..., T, D] uint8 in 0..15,
    scales [..., 2, T] bf16: row 0 scale, row 1 zero-point)."""
    xf = x.float()
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    scale = (mx - mn) / _const(15.0, xf.device) + 1e-8
    q = torch.round((xf - mn) / scale).clamp(0, 15).to(torch.uint8)
    scales = torch.stack([scale[..., 0], mn[..., 0]], dim=-2)
    return q, scales.to(torch.bfloat16)


def quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat layout: [..., T, D] -> (packed [..., T, D//2] uint8 with byte d =
    channel d | channel d + D/2 << 4, scales [..., 2, T] bf16)."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"int4 packing needs an even head_dim, got {D}")
    q, scales = quantize_int4_nibbles(x)
    return q[..., : D // 2] | (q[..., D // 2 :] << 4), scales


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Flat layout, no scaling: [..., D//2] uint8 -> [..., D] uint8."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_int4, float32."""
    q = unpack_int4(packed).float()
    return q * scales[..., 0, :, None].float() + scales[..., 1, :, None].float()


def quantize_int4_paired(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-paired cache layout: [..., S, D] (S even) ->
    (packed2 [..., S//2, D] uint8, scales4 [..., 4, S//2] bf16)."""
    S = x.shape[-2]
    if S % 2:
        raise ValueError(f"token-paired int4 needs an even number of tokens, got {S}")
    q, scales = quantize_int4_nibbles(x)
    packed2 = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
    scale, zp = scales[..., 0, :], scales[..., 1, :]
    scales4 = torch.stack([scale[..., 0::2], scale[..., 1::2], zp[..., 0::2], zp[..., 1::2]], dim=-2)
    return packed2, scales4


def dequantize_int4_paired(packed2: torch.Tensor, scales4: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_int4_paired: -> [..., S, D] float32."""
    *lead, half_s, D = packed2.shape
    q = torch.stack([(packed2 & 0xF).float(), (packed2 >> 4).float()], dim=-2)
    q = q.reshape(*lead, half_s * 2, D)
    scale = torch.stack([scales4[..., 0, :], scales4[..., 1, :]], dim=-1).reshape(*lead, half_s * 2)
    zp = torch.stack([scales4[..., 2, :], scales4[..., 3, :]], dim=-1).reshape(*lead, half_s * 2)
    return q * scale[..., None].float() + zp[..., None].float()


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric int8. w [out, in] -> (wq [out, in] int8,
    scale [out] float32)."""
    wf = w.float()
    scale = wf.abs().amax(dim=1, keepdim=True) / _const(127.0, wf.device) + 1e-12
    wq = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return wq, scale[:, 0]


def quantize_act_per_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8. x [..., E] -> (xq int8, scale
    [..., 1] float32)."""
    xf = x.float()
    return _quantize_rows(xf, xf.abs().amax(dim=-1, keepdim=True))


def _quantize_rows(xf: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 rows [..., E] with their absmax [..., 1] -> (xq int8, scale)."""
    scale = absmax / _const(127.0, xf.device) + 1e-12
    xq = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return xq, scale


def int8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """(xq [..., in] int8) x (wq [out, in] int8) with the float32 scale
    epilogue, in plain PyTorch on any device (exact; the reference form)."""
    lead = xq.shape[:-1]
    out = w8a8_matmul_plain(xq.reshape(-1, xq.shape[-1]), x_scale.reshape(-1, 1), wq, w_scale, out_dtype)
    return out.reshape(*lead, wq.shape[0])


def _quantize_span(x: torch.Tensor):
    """The ``engine.quantize_act`` span of one eager quantization of x: one
    flag check while spans are not recorded, and ``tracing.NULL`` during a
    CUDA graph capture."""
    if not tracing.active() or (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        return tracing.NULL
    return tracing.span("engine.quantize_act", device=x.device)


def _group_forward(x: torch.Tensor, weights, out_dtype, plain: bool) -> Tuple[torch.Tensor, ...]:
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x.is_cuda and not plain and x2.shape[0] <= SMALL_M_MAX:
        outs = w8a8_small_group(x2, weights, out_dtype)
    else:
        with _quantize_span(x2):
            xq, xs = quantize_act_per_token(x2)
        fn = w8a8_matmul_plain if plain else w8a8_matmul
        outs = [fn(xq, xs, wq, ws, out_dtype) for wq, ws in weights]
    return tuple(out.reshape(*lead, out.shape[-1]) for out in outs)


class _W8A8STE(torch.autograd.Function):
    """The W8A8 linears of one x with JAX's straight-through backward
    (duo_attention_tpu/ops/quant.py ``_w8a8_linear_ste_bwd``): for each
    weight ``dx_i = bf16(float32(g_i) * w_scale_i) @ bf16(wq_i)``, in
    bfloat16 with float32 accumulation, cast to x's dtype. The group's dx is
    the sum of those terms in x's dtype, as JAX's autodiff sums the
    cotangents of separate linears: the last weight's term first, then each
    earlier one added (``(dv + dk) + dq``). The weights and scales are frozen
    and get no gradient."""

    @staticmethod
    def forward(ctx, x, out_dtype, plain, *flat):
        ctx.save_for_backward(*flat)
        ctx.x_dtype = x.dtype
        return _group_forward(x, list(zip(flat[0::2], flat[1::2])), out_dtype, plain)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.saved_tensors
        dx = None
        for g, wq, ws in reversed(list(zip(grads, flat[0::2], flat[1::2]))):
            term = ((g.float() * ws).to(torch.bfloat16) @ wq.to(torch.bfloat16)).to(ctx.x_dtype)
            dx = term if dx is None else dx + term
        return (dx, None, None, *([None] * len(flat)))


def w8a8_linear_group(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      out_dtype=torch.bfloat16, plain: bool = False) -> Tuple[torch.Tensor, ...]:
    """Dynamic-activation W8A8 linears of one input: x [..., in] bfloat16 or
    float32 (the plain path takes any float dtype; the small-M kernel raises
    on others), weights 1-3 (wq [out_i, in] int8, w_scale [out_i] float32)
    -> a tuple of [..., out_i] ``out_dtype``.

    Each output is bitwise ``w8a8_linear(x, wq_i, w_scale_i)``: x is
    quantized per token once, then multiplied by each weight. A CUDA x of at
    most ``gemm.SMALL_M_MAX`` tokens takes the small-M kernel, which does
    both in one launch for the whole group (past 8 tokens x is quantized by
    a launch of its own first); more tokens are quantized in plain torch,
    then each product is ``gemm.w8a8_matmul`` (the tiled kernel).
    ``plain=True`` (or a CPU x) runs the plain versions. When x requires a
    gradient (and grad mode is on) the same forward runs inside ``_W8A8STE``,
    whose backward is the straight-through estimator."""
    if x.requires_grad and torch.is_grad_enabled():
        return _W8A8STE.apply(x, out_dtype, plain, *(t for pair in weights for t in pair))
    return _group_forward(x, weights, out_dtype, plain)


def w8a8_linear(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """One W8A8 linear: ``w8a8_linear_group`` of a single weight."""
    return w8a8_linear_group(x, [(wq, w_scale)], out_dtype, plain)[0]


def w8a8_linear_row_split(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, mesh,
                          out_dtype=torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """A W8A8 linear whose input dimension is split over the mesh's tensor
    ranks (wo and w_down under tensor parallelism): x [..., in_local], wq
    [out, in_local] int8, w_scale [out] float32 (whole) -> [..., out]
    ``out_dtype``, the same on every rank.

    The per-token scale must be the whole row's, as GSPMD's psum-max makes
    it: the local absmax is all_reduced (MAX), the local slice quantized
    with it exactly as ``quantize_act_per_token`` would quantize the whole
    row, multiplied in ``gemm.w8a8_matmul``'s int8-input mode (the small-M
    kernel up to ``SMALL_M_MAX`` rows, the tiled one past it) with float32
    output, and the partial products all_reduced (SUM) in float32, then cast.
    JAX sums the int32 partials and applies the scales once, so the two
    differ by float32 rounding only. ``plain=True`` (or a CPU x) runs the
    plain product."""
    from ..parallel.mesh import all_reduce

    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K).float()
    xq, xs = _quantize_rows(xf, all_reduce(mesh, xf.abs().amax(dim=-1, keepdim=True), "max"))
    fn = w8a8_matmul_plain if plain else w8a8_matmul
    out = all_reduce(mesh, fn(xq, xs, wq, w_scale, torch.float32))
    return out.to(out_dtype).reshape(*lead, wq.shape[0])


def quantize_layer_weights(layer: Dict, keys=QUANTIZED_PROJECTIONS) -> Dict:
    """Replace the selected weights of a layer with (name_q8, name_scale)."""
    out = dict(layer)
    for k in keys:
        if k in layer:
            out[k + "_q8"], out[k + "_scale"] = quantize_weight_int8(out.pop(k))
    return out


def quantize_params_w8a8(params: Dict) -> Dict:
    """Quantize every decoder layer's projections; embed, norms and lm_head
    stay in high precision."""
    out = dict(params)
    out["layers"] = [quantize_layer_weights(layer) for layer in params["layers"]]
    return out


def quantize_embeddings_int8(params: Dict) -> Dict:
    """Quantize embed (per row) and lm_head (per out-channel) to int8. Embed
    rows are dequantized at lookup; the head runs through the W8A8 linear."""
    out = dict(params)
    if "embed" in out:
        # both are [rows, E] with a scale per row
        out["embed_q8"], out["embed_scale"] = quantize_weight_int8(out.pop("embed"))
    if "lm_head" in out:
        out["lm_head_q8"], out["lm_head_scale"] = quantize_weight_int8(out.pop("lm_head"))
    return out


def init_params_w8a8(cfg, seed: int = 0, dtype=torch.bfloat16, device="cuda",
                     quantize_embeds: bool = False, shard=None) -> Dict:
    """Random W8A8 params, one layer at a time: each layer is drawn in
    ``dtype``, quantized and its source dropped, so peak memory is the int8
    model plus one high-precision layer. Draws come from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (raises when
    device is "cuda" and no GPU is present). ``shard`` as in
    ``llama.init_params``, applied after quantization."""
    from ..models import llama

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shard = shard or llama._keep
    layers = [shard(li, quantize_layer_weights(llama.init_layer(cfg, gen, dtype, dev)))
              for li in range(cfg.num_layers)]
    top = llama.init_top(cfg, gen, dtype, dev)
    top = shard(None, quantize_embeddings_int8(top) if quantize_embeds else top)
    top["layers"] = layers
    return top


def init_params_w8a8_random(cfg, seed: int = 0, device="cuda", quantize_embeds: bool = True, shard=None) -> Dict:
    """Random W8A8 params with the int8 tensors drawn DIRECTLY, uniform in
    [-127, 127], and every weight scale fan_in**-0.5 / 127 (activations stay
    O(1)). For benchmarks and smoke runs, whose speed does not depend on the
    values: no high-precision weight is ever allocated. As JAX's, it draws
    dense layers whatever ``cfg.num_local_experts`` says (a W8A8 MoE model
    comes from ``init_params_w8a8``). ``shard`` as in ``llama.init_params``."""
    from ..models import llama

    dev = resolve_device(device)
    shard = shard or llama._keep
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, D, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads

    def rand_q8(out_f, in_f):
        w = torch.randint(-127, 128, (out_f, in_f), generator=gen, device=dev, dtype=torch.int8)
        return w, torch.full((out_f,), in_f**-0.5 / 127.0, dtype=torch.float32, device=dev)

    layers = []
    for li in range(cfg.num_layers):
        layer = {"input_norm": torch.ones(E, dtype=torch.bfloat16, device=dev),
                 "post_norm": torch.ones(E, dtype=torch.bfloat16, device=dev)}
        for name, out_f, in_f in (("wq", Hq * D, E), ("wk", Hkv * D, E), ("wv", Hkv * D, E),
                                  ("wo", E, Hq * D), ("w_gate", I, E), ("w_up", I, E), ("w_down", E, I)):
            layer[name + "_q8"], layer[name + "_scale"] = rand_q8(out_f, in_f)
        layers.append(shard(li, layer))
    top = {"final_norm": torch.ones(E, dtype=torch.bfloat16, device=dev)}
    if quantize_embeds:
        top["embed_q8"] = torch.randint(-127, 128, (V, E), generator=gen, device=dev, dtype=torch.int8)
        top["embed_scale"] = torch.full((V,), 0.02 / 127.0, dtype=torch.float32, device=dev)
        top["lm_head_q8"], top["lm_head_scale"] = rand_q8(V, E)
    else:
        top.update(llama.init_top(cfg, gen, torch.bfloat16, dev))  # embed, final_norm, lm_head
    top = shard(None, top)
    top["layers"] = layers
    return top
