"""Plain float32 reference of the served models, with DuoAttention's semantics.

A dense (Mistral) or top-k routed MoE (Mixtral) decoder over the weights of
``core/weights.py``, made again layer by layer from the run's seed, in
natural head order: the configuration's head lists say which KV heads are
retrieval heads. TF32 is off. Nothing of the program is imported or read.

What a served token's logits depend on, written out from the model's
published description and DuoAttention's cache:

- RoPE, rotate-half layout, angles in float64; RMSNorm with eps; SwiGLU.
- A retrieval (full) head's query at position p sees keys 0..p.
- A streaming head's query at position p sees the sink (keys below
  ``sink_size``) and the keys from max(sink, c - recent) to p, c the start
  of the prefill chunk p was prefilled in (chunks start at multiples of the
  chunk size) or, for a decoded token, p itself: a chunk reads the window
  as it stood at the chunk's start, a decode step reads the last ``recent``
  keys and its own.
- A MoE layer routes each token to the top-k router logits (float32) and
  weighs the chosen experts by the softmax over those k logits.

``logits_at`` runs every request through one layer at a time, queries in
blocks, so a 29k-token request fits beside the model.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from ..core.weights import Shape, make_layer, make_top

MLP_ROWS = 8192  # rows of the MLP computed at once


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rope_tables(shape: Shape, n: int, device):
    """cos, sin [n, D] float32 from float64 angles (rotate-half layout)."""
    D = shape.head_dim
    inv = 1.0 / (shape.rope_theta ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
    ang = np.concatenate([ang, ang], axis=1)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, H, D]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def float_layer(layer: dict) -> dict:
    return {k: v.float() for k, v in layer.items()}


def int8_rows(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 rounding of each row (per output channel of a weight,
    per token of an activation), returned dequantized in float32."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


def lin(x: torch.Tensor, w: torch.Tensor, int8: bool = False) -> torch.Tensor:
    """x @ w.T in float32; ``int8``: both rounded to int8 first (the control:
    W8A8 in every product, as an int8 path computes it)."""
    if int8:
        return int8_rows(x) @ int8_rows(w).t()
    return x @ w.t()


def attention(q, k, v, full: Sequence[bool], chunk_start: torch.Tensor, sink: int, recent: int,
              block: int = 1024) -> torch.Tensor:
    """q [N, Hq, D], k/v [N, Hkv, D] (positions 0..N-1), one flag a KV head
    (True: retrieval head), chunk_start [N] int64. Returns [N, Hq, D]."""
    N, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    dev = q.device
    for a in range(0, N, block):
        b = min(N, a + block)
        p = torch.arange(a, b, device=dev)
        c = chunk_start[a:b]
        for h in range(Hkv):
            if full[h]:
                idx = torch.arange(b, device=dev)
                mask = idx[None, :] <= p[:, None]
            else:
                lo = max(sink, int(c.min()) - recent)
                idx = torch.cat([torch.arange(min(sink, b), device=dev), torch.arange(max(lo, sink), b, device=dev)])
                win = torch.clamp(c - recent, min=sink)
                mask = (idx[None, :] <= p[:, None]) & ((idx[None, :] < sink) | (idx[None, :] >= win[:, None]))
            qh = q[a:b, h * G : (h + 1) * G].transpose(0, 1)  # [G, n, D]
            s = qh @ k[idx, h].t() / math.sqrt(D)
            s = s.masked_fill(~mask[None], float("-inf")).softmax(dim=-1)
            out[a:b, h * G : (h + 1) * G] = (s @ v[idx, h]).transpose(0, 1)
    return out


def mlp(h: torch.Tensor, layer: dict, shape: Shape, int8: bool = False, margin=None) -> torch.Tensor:
    """SwiGLU, or a MoE layer's top-k routed experts. ``margin`` [rows]: where
    given, each row's router margin is written there (its k-th router logit
    less its (k+1)-th: how far the routing is from a tie)."""
    silu = torch.nn.functional.silu
    out = torch.empty_like(h)
    for a in range(0, h.shape[0], MLP_ROWS):
        x = h[a : a + MLP_ROWS]
        if not shape.experts:
            out[a : a + MLP_ROWS] = lin(silu(lin(x, layer["w_gate"], int8)) * lin(x, layer["w_up"], int8),
                                        layer["w_down"], int8)
            continue
        logits = x @ layer["moe_gate"]  # [n, X]
        if margin is not None:
            top = torch.topk(logits, shape.top_k + 1, dim=-1).values
            margin[a : a + MLP_ROWS] = top[:, -2] - top[:, -1]
        top_v, top_i = torch.topk(logits, shape.top_k, dim=-1)
        weight = top_v.softmax(dim=-1)
        y = torch.zeros_like(x)
        for e in range(shape.experts):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = lin(silu(lin(xe, layer["experts_w_gate"][e], int8)) * lin(xe, layer["experts_w_up"][e], int8),
                     layer["experts_w_down"][e], int8)
            y.index_add_(0, rows, ye * weight[rows, slot][:, None])
        out[a : a + MLP_ROWS] = y
    return out


def decoder_layer(x: torch.Tensor, layer: dict, shape: Shape, full: Sequence[bool], chunk_start: torch.Tensor,
                  cos, sin, sink: int, recent: int, int8: bool = False, margin=None) -> torch.Tensor:
    N, D = x.shape[0], shape.head_dim
    h = rms(x, layer["input_norm"], shape.eps)
    q = rope(lin(h, layer["wq"], int8).view(N, shape.heads, D), cos, sin)
    k = rope(lin(h, layer["wk"], int8).view(N, shape.kv_heads, D), cos, sin)
    v = lin(h, layer["wv"], int8).view(N, shape.kv_heads, D)
    a = attention(q, k, v, full, chunk_start, sink, recent)
    x = x + lin(a.reshape(N, -1), layer["wo"], int8)
    return x + mlp(rms(x, layer["post_norm"], shape.eps), layer, shape, int8, margin)


def full_flags(conf: dict, li: int) -> List[bool]:
    heads = set(conf["duo"]["full_kv_heads"][li])
    return [h in heads for h in range(conf["num_key_value_heads"])]


def served_layout(prompt_len: int, served: int, chunk: int):
    """For a request with ``served`` tokens: the positions fed (prompt and
    every served token but the last), each position's chunk start, and the
    positions whose logits chose the served tokens."""
    n = prompt_len + served - 1
    p = np.arange(n, dtype=np.int64)
    c = np.where(p < prompt_len, p // chunk * chunk, p)
    return n, c, np.arange(prompt_len - 1, n)


@torch.no_grad()
def logits_at(conf: dict, seed: int, requests: Sequence[tuple], device, int8: bool = False,
              margins: list = None) -> List[torch.Tensor]:
    """requests: (prompt ids, served token ids) pairs. Returns, for each, the
    float32 logits [served, V] at the positions that chose its tokens.
    ``int8``: the control, every product in W8A8 (``lin``); the router stays
    float32. ``margins``: a list that receives, for each request of a MoE
    model, the smallest router margin over the layers at those positions."""
    no_tf32()
    shape = Shape.of(conf)
    duo = conf["duo"]
    top = {k: v.float() for k, v in make_top(shape, seed, device).items()}
    xs, starts, picks = [], [], []
    for prompt, served in requests:
        n, c, pick = served_layout(len(prompt), len(served), duo["prefill_chunk_size"])
        ids = torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(served[:-1])])[:n].astype(np.int64),
                              device=device)
        xs.append(top["embed"][ids])
        starts.append(torch.as_tensor(c, device=device))
        picks.append(torch.as_tensor(pick, device=device))
    n_max = max(x.shape[0] for x in xs)
    cos, sin = rope_tables(shape, n_max, device)
    lows = [torch.full((x.shape[0],), float("inf"), device=device) for x in xs] if shape.experts else None
    for li in range(shape.layers):
        layer = float_layer(make_layer(shape, seed, li, device))
        full = full_flags(conf, li)
        for r, x in enumerate(xs):
            n = x.shape[0]
            margin = torch.empty((n,), device=device) if lows else None
            xs[r] = decoder_layer(x, layer, shape, full, starts[r], cos[:n], sin[:n], duo["sink_size"],
                                  duo["recent_size"], int8, margin)
            if lows:
                torch.minimum(lows[r], margin, out=lows[r])
        del layer
    if margins is not None and lows:
        margins.extend(low[pick].cpu().numpy() for low, pick in zip(lows, picks))
    return [lin(rms(x[pick], top["final_norm"], shape.eps), top["lm_head"], int8) for x, pick in zip(xs, picks)]


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    """How far each token's logit lies below the best logit of its row."""
    tok = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=logits.device)
    return (logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]).cpu().numpy()
