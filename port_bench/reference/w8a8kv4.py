"""Plain float32 reference of a dense model served in DuoAttention's
deployment format: W8A8 weights, an int8 embedding and head, an INT4 cache
for the retrieval (full) heads and an unquantized one for the streaming heads.

The same model as ``reference/model.py`` (its RoPE, RMSNorm, SwiGLU and
DuoAttention masks, the weights of ``core/weights.py`` made again from the
seed), with the format's roundings written out from the program's published
formulas (``duo_attention_tpu_torch/ops/quant.py``'s docstring), in float32
with TF32 off. Nothing of the program is imported; no cache, kernel or batch.

- Weights: every decoder projection (wq, wk, wv, wo, w_gate, w_up, w_down)
  and the head, symmetric int8 per output channel: scale = amax / 127 +
  1e-12 (``model.int8_rows`` clamps the amax instead), q = round(w / scale)
  clipped to [-127, 127]. The embedding table the same way per row, its
  rows dequantized at lookup.
- Activations: at every projection's input (the normed residual for wq, wk
  and wv and for w_gate and w_up, the attention output for wo, the SwiGLU
  product for w_down, the final normed state for the head) each token is
  rounded to int8 by the same formula with its own absmax; the product is
  (xq . wq) x_scale w_scale.
- Full heads: each key after RoPE and each value, per (token, head) over
  head_dim: scale = (max - min) / 15 + 1e-8, nibble = round((x - min) /
  scale) clipped to [0, 15], read back as nibble * bf16(scale) + bf16(min):
  the cache stores the scale and zero point rounded to bf16.
- Which keys a query reads in INT4: all of a full head's keys and values.
  The program writes a chunk's K and V into the INT4 cache before it attends
  (``models/llama.py::_duo_layer_attention``: ``write_full_q4_pair``, then
  ``full_cache_attention_q4`` over the cache up to the chunk's end), so a
  prefill query reads the earlier chunks' keys, its own chunk's, and its
  own key rounded; a decode step writes its token first and reads every
  key, its own included, rounded. Streaming heads read unrounded keys.

Departures from the program: activations are float32 between products,
where the program holds them in bf16 (its residual stream, RoPE's output,
the attention output and the streaming cache); the int8 sum is taken in
float32 (inexact past 2^24, about 1e-7 of it), the program's is exact; the
softmax scale is not folded into q in bf16. So a value that lies near a
rounding boundary of int8 or INT4 can round to the next step here and not
there. At the published widths such re-roundings put the program's served
tokens about as far from this reference as a program without the INT4
cache or without W8A8, which is why the check also reads how much nearer
they lie to it than to the same reference without either half
(``served_kv4_gap_ratio``, ``served_w8a8_gap_ratio``,
``drivers/closed_loop_formatted.py``).

The precision is ``logits_at``'s to set, the format's by default:
``weight_bits`` (8: W8A8; None: float32 weights, activations, embedding and
head) and ``kv_bits`` (4: the full heads' INT4 cache; None: unrounded)
leave out either half of the format, for the tests and the correctness
check (``drivers/closed_loop_formatted.py``); ``weight_bits=4`` (the
decoder's projections symmetric INT4 per output channel, qmax 7, over the
same int8 activations; the embedding and head stay int8), ``kv_bits=2``
(the full heads' K and V at 3 levels) and ``stream_kv_bits=4`` (the
streaming heads rounded as the full heads are) compute it in a lower
precision, the controls that a program below the format fails
(``control_quantized.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.weights import Shape, make_layer, make_top
from .model import MLP_ROWS, attention, full_flags, no_tf32, rms, rope, rope_tables, served_layout

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as an IEEE division (a 0-d tensor divisor; a Python number
    is a multiplication by its reciprocal on the card)."""
    return x / torch.full((), value, dtype=torch.float32, device=x.device)


def int_rows(t: torch.Tensor, bits: int = 8):
    """Symmetric integers of each row of a float32 [rows, n]: (the integers
    as float32, scale [rows, 1]), qmax = 2^(bits - 1) - 1 (int8: 127),
    scale = amax / qmax + 1e-12."""
    qmax = 2 ** (bits - 1) - 1
    scale = _div(t.abs().amax(dim=-1, keepdim=True), float(qmax)) + 1e-12
    return torch.round(t / scale).clamp(-qmax, qmax), scale


def int_heads(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """x [N, H, D] float32 rounded per (token, head) to 2^bits levels (INT4:
    16) and read back, with the scale and zero point rounded to bf16 as the
    cache stores them."""
    top = 2**bits - 1
    mn, mx = x.amin(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)
    scale = _div(mx - mn, float(top)) + 1e-8
    q = torch.round((x - mn) / scale).clamp(0, top)
    return q * scale.bfloat16().float() + mn.bfloat16().float()


class Linear:
    """One projection [out, in]: its weights rounded to ``bits`` per output
    channel over int8 activations per token (8: W8A8), or float32 (None)."""

    def __init__(self, w: torch.Tensor, bits):
        self.bits = bits
        if bits:
            self.wq, scale = int_rows(w.float(), bits)
            self.scale = scale[:, 0]
        else:
            self.w = w.float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.bits:
            return x @ self.w.t()
        xq, xs = int_rows(x)
        return (xq @ self.wq.t()) * xs * self.scale


def layer_linears(layer: dict, bits) -> dict:
    out = {k: Linear(layer[k], bits) for k in PROJECTIONS}
    out.update(input_norm=layer["input_norm"].float(), post_norm=layer["post_norm"].float())
    return out


def decoder_layer(x: torch.Tensor, lin: dict, shape: Shape, full: Sequence[bool], chunk_start: torch.Tensor,
                  cos, sin, sink: int, recent: int, kv_bits, stream_kv_bits) -> torch.Tensor:
    N, D = x.shape[0], shape.head_dim
    h = rms(x, lin["input_norm"], shape.eps)
    q = rope(lin["wq"](h).view(N, shape.heads, D), cos, sin)
    k = rope(lin["wk"](h).view(N, shape.kv_heads, D), cos, sin)
    v = lin["wv"](h).view(N, shape.kv_heads, D)
    for bits, kind in ((kv_bits, True), (stream_kv_bits, False)):
        if bits:
            hs = torch.as_tensor([i for i, f in enumerate(full) if f == kind], dtype=torch.long, device=x.device)
            k[:, hs], v[:, hs] = int_heads(k[:, hs], bits), int_heads(v[:, hs], bits)
    a = attention(q, k, v, full, chunk_start, sink, recent)
    x = x + lin["wo"](a.reshape(N, -1))
    h = rms(x, lin["post_norm"], shape.eps)
    out = torch.empty_like(x)
    for a0 in range(0, N, MLP_ROWS):
        hb = h[a0 : a0 + MLP_ROWS]
        out[a0 : a0 + MLP_ROWS] = lin["w_down"](torch.nn.functional.silu(lin["w_gate"](hb)) * lin["w_up"](hb))
    return x + out


@torch.no_grad()
def logits_at(conf: dict, seed: int, requests: Sequence[tuple], device, weight_bits: Optional[int] = 8,
              kv_bits: Optional[int] = 4, stream_kv_bits: Optional[int] = None) -> List[torch.Tensor]:
    """requests: (prompt ids, served token ids) pairs. Returns, for each, the
    float32 logits [served, V] at the positions that chose its tokens, in
    the precision the bits give (the module's docstring; None: unrounded)."""
    no_tf32()
    shape = Shape.of(conf)
    if shape.experts:
        raise ValueError("the W8A8KV4 reference is of dense models")
    duo = conf["duo"]
    top = make_top(shape, seed, device)
    if weight_bits:
        table, scale = int_rows(top["embed"].float())
        embed = lambda ids: table[ids] * scale[ids]  # noqa: E731
    else:
        embed = lambda ids, t=top["embed"].float(): t[ids]  # noqa: E731
    head = Linear(top["lm_head"], 8 if weight_bits else None)
    final_norm = top["final_norm"].float()
    del top
    xs, starts, picks = [], [], []
    for prompt, served in requests:
        n, c, pick = served_layout(len(prompt), len(served), duo["prefill_chunk_size"])
        ids = torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])[:n].astype(np.int64),
                              device=device)
        xs.append(embed(ids))
        starts.append(torch.as_tensor(c, device=device))
        picks.append(torch.as_tensor(pick, device=device))
    cos, sin = rope_tables(shape, max(x.shape[0] for x in xs), device)
    for li in range(shape.layers):
        lin = layer_linears(make_layer(shape, seed, li, device), weight_bits)
        full = full_flags(conf, li)
        for r, x in enumerate(xs):
            n = x.shape[0]
            xs[r] = decoder_layer(x, lin, shape, full, starts[r], cos[:n], sin[:n], duo["sink_size"],
                                  duo["recent_size"], kv_bits, stream_kv_bits)
        del lin
    return [head(rms(x[pick], final_norm, shape.eps)) for x, pick in zip(xs, picks)]
