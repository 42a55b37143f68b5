"""Quantization ops: asymmetric per-token INT4 KV and W8A8 linears.

Counterpart of duo_attention_tpu/ops/quant.py, forward only (the
straight-through backward of the JAX ``w8a8_linear`` belongs to training).

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
  card at M <= ``gemm.SMALL_M_MAX`` one kernel quantizes x and multiplies it
  by each weight (``gemm.w8a8_small_group``); otherwise x is quantized once
  in plain torch and each product is ``gemm.w8a8_matmul``.

Weights here are ``[out_features, in_features]`` (PyTorch's layout); the JAX
package keeps ``[in, out]``. ``models/from_jax.py`` transposes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

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
    scale = xf.abs().amax(dim=-1, keepdim=True) / _const(127.0, xf.device) + 1e-12
    xq = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return xq, scale


def int8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """(xq [..., in] int8) x (wq [out, in] int8) with the float32 scale
    epilogue, in plain PyTorch on any device (exact; the reference form)."""
    lead = xq.shape[:-1]
    out = w8a8_matmul_plain(xq.reshape(-1, xq.shape[-1]), x_scale.reshape(-1, 1), wq, w_scale, out_dtype)
    return out.reshape(*lead, wq.shape[0])


def w8a8_linear_group(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      out_dtype=torch.bfloat16, plain: bool = False) -> Tuple[torch.Tensor, ...]:
    """Dynamic-activation W8A8 linears of one input, forward only: x [...,
    in] bfloat16 or float32 (the plain path takes any float dtype; the
    small-M kernel raises on others), weights 1-3 (wq [out_i, in] int8,
    w_scale [out_i] float32) -> a tuple of [..., out_i] ``out_dtype``.

    Each output is bitwise ``w8a8_linear(x, wq_i, w_scale_i)``: x is
    quantized per token once, then multiplied by each weight. A CUDA x of at
    most ``gemm.SMALL_M_MAX`` tokens takes the small-M kernel, which does
    both in one launch for the whole group; more tokens are quantized in
    plain torch, then each product is ``gemm.w8a8_matmul`` (the tiled kernel).
    ``plain=True`` (or a CPU x) runs the plain versions."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x.is_cuda and not plain and x2.shape[0] <= SMALL_M_MAX:
        outs = w8a8_small_group(x2, weights, out_dtype)
    else:
        xq, xs = quantize_act_per_token(x2)
        fn = w8a8_matmul_plain if plain else w8a8_matmul
        outs = [fn(xq, xs, wq, ws, out_dtype) for wq, ws in weights]
    return tuple(out.reshape(*lead, out.shape[-1]) for out in outs)


def w8a8_linear(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """One W8A8 linear: ``w8a8_linear_group`` of a single weight."""
    return w8a8_linear_group(x, [(wq, w_scale)], out_dtype, plain)[0]


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
                     quantize_embeds: bool = False) -> Dict:
    """Random W8A8 params, one layer at a time: each layer is drawn in
    ``dtype``, quantized and its source dropped, so peak memory is the int8
    model plus one high-precision layer. Draws come from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (raises when
    device is "cuda" and no GPU is present)."""
    from ..models import llama

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = [quantize_layer_weights(llama.init_layer(cfg, gen, dtype, dev)) for _ in range(cfg.num_layers)]
    top = llama.init_top(cfg, gen, dtype, dev)
    top["layers"] = layers
    return quantize_embeddings_int8(top) if quantize_embeds else top


def init_params_w8a8_random(cfg, seed: int = 0, device="cuda", quantize_embeds: bool = True) -> Dict:
    """Random W8A8 params with the int8 tensors drawn DIRECTLY, uniform in
    [-127, 127], and every weight scale fan_in**-0.5 / 127 (activations stay
    O(1)). For benchmarks and smoke runs, whose speed does not depend on the
    values: no high-precision weight is ever allocated."""
    if cfg.num_local_experts > 0:
        raise NotImplementedError("MoE MLPs are not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, D, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads

    def rand_q8(out_f, in_f):
        w = torch.randint(-127, 128, (out_f, in_f), generator=gen, device=dev, dtype=torch.int8)
        return w, torch.full((out_f,), in_f**-0.5 / 127.0, dtype=torch.float32, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {"input_norm": torch.ones(E, dtype=torch.bfloat16, device=dev),
                 "post_norm": torch.ones(E, dtype=torch.bfloat16, device=dev)}
        for name, out_f, in_f in (("wq", Hq * D, E), ("wk", Hkv * D, E), ("wv", Hkv * D, E),
                                  ("wo", E, Hq * D), ("w_gate", I, E), ("w_up", I, E), ("w_down", E, I)):
            layer[name + "_q8"], layer[name + "_scale"] = rand_q8(out_f, in_f)
        layers.append(layer)
    top = {"layers": layers, "final_norm": torch.ones(E, dtype=torch.bfloat16, device=dev)}
    if quantize_embeds:
        top["embed_q8"] = torch.randint(-127, 128, (V, E), generator=gen, device=dev, dtype=torch.int8)
        top["embed_scale"] = torch.full((V,), 0.02 / 127.0, dtype=torch.float32, device=dev)
        top["lm_head_q8"], top["lm_head_scale"] = rand_q8(V, E)
    else:
        from ..models import llama

        top.update(llama.init_top(cfg, gen, torch.bfloat16, dev))  # embed, final_norm, lm_head
    return top
