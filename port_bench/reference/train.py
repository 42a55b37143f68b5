"""Plain float32 reference of gate training: the two-way loss, its gate
gradient, and AdamW with the clamp, step by step.

Written out from DuoAttention's training objective: a teacher with full
causal attention in every head; a student whose heads mix, per KV head's
gate alpha (clipped to [0, 1]), (1 - alpha) x its Λ-masked attention (the
sink and the last ``recent`` positions, itself included) with alpha x the
teacher's full attention output of the same layer; the loss is the mean
over supervised positions of the mean squared gap between the two final
hidden states (after the final norm), plus ``reg_weight`` x mean |gates|.
A position t is supervised when the label of t + 1 is not ignored (hidden
state t predicts token t + 1). The optimizer is AdamW (decoupled weight
decay, bias-corrected moments) at a linear warmup then linear decay of the
learning rate, taken at the count of earlier updates; gates are clamped to
[0, 1] after each update.

Weights come from ``core/weights.py`` and are made again from the seed;
nothing of the program is imported. TF32 is off. Each student layer is
recomputed in the backward (``torch.utils.checkpoint``), so the 32-layer
model at 4k tokens fits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.weights import Shape, make_layer, make_top
from .model import float_layer, mlp, no_tf32, rms, rope, rope_tables

IGNORE = -100


def masked_attention(q, k, v, sink: int, recent, block: int = 1024) -> torch.Tensor:
    """Causal attention; ``recent`` None: every earlier key (the teacher),
    else the Λ-mask. q [S, Hq, D], k/v [S, Hkv, D]."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    kq = k.repeat_interleave(G, dim=1)
    vq = v.repeat_interleave(G, dim=1)
    outs = []
    dev = q.device
    for a in range(0, S, block):
        b = min(S, a + block)
        p = torch.arange(a, b, device=dev)
        if recent is None:
            idx = torch.arange(b, device=dev)
            mask = idx[None, :] <= p[:, None]
        else:
            lo = max(sink, a - recent + 1)
            idx = torch.cat([torch.arange(min(sink, b), device=dev), torch.arange(max(lo, sink), b, device=dev)])
            mask = (idx[None, :] <= p[:, None]) & ((idx[None, :] < sink) | (idx[None, :] > p[:, None] - recent))
        s = torch.einsum("qhd,khd->hqk", q[a:b], kq[idx]) / math.sqrt(D)
        s = s.masked_fill(~mask[None], float("-inf")).softmax(dim=-1)
        outs.append(torch.einsum("hqk,khd->qhd", s, vq[idx]))
    return torch.cat(outs, dim=0)


def _attn_in(layer, x, shape: Shape, cos, sin):
    S, D = x.shape[0], shape.head_dim
    h = rms(x, layer["input_norm"], shape.eps)
    q = rope((h @ layer["wq"].t()).view(S, shape.heads, D), cos, sin)
    k = rope((h @ layer["wk"].t()).view(S, shape.kv_heads, D), cos, sin)
    return q, k, (h @ layer["wv"].t()).view(S, shape.kv_heads, D)


def _block_out(layer, x, attn, shape: Shape):
    x = x + attn.reshape(x.shape[0], -1) @ layer["wo"].t()
    return x + mlp(rms(x, layer["post_norm"], shape.eps), layer, shape)


def two_way_loss(layers: List[dict], top: dict, shape: Shape, gates: torch.Tensor, ids: torch.Tensor,
                 supervised: torch.Tensor, sink: int, recent: int, reg_weight: float) -> torch.Tensor:
    S = ids.shape[0]
    cos, sin = rope_tables(shape, S, ids.device)
    G = shape.groups
    ht = hs = top["embed"][ids].float()

    def student(layer_bf16, alpha, hs, full_out):
        layer = float_layer(layer_bf16)
        stream = masked_attention(*_attn_in(layer, hs, shape, cos, sin), sink, recent)
        a = torch.clamp(alpha, 0.0, 1.0).repeat_interleave(G)[None, :, None]
        return _block_out(layer, hs, (1.0 - a) * stream + a * full_out, shape)

    for li, layer_bf16 in enumerate(layers):
        with torch.no_grad():
            layer = float_layer(layer_bf16)
            full_out = masked_attention(*_attn_in(layer, ht, shape, cos, sin), sink, None)
            ht = _block_out(layer, ht, full_out, shape)
            del layer
        hs = checkpoint(student, layer_bf16, gates[li], hs, full_out, use_reentrant=False)
    ht = rms(ht, top["final_norm"], shape.eps)
    hs = rms(hs, top["final_norm"], shape.eps)
    per_pos = ((ht - hs) ** 2).mean(dim=-1)
    distill = (per_pos * supervised).sum() / supervised.sum().clamp(min=1.0)
    return distill + reg_weight * gates.abs().mean()


def learning_rate(opt: Dict, count: int) -> float:
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["num_steps"]
    if count < warm:
        return lr * min(count / max(warm, 1), 1.0)
    return lr * max(1.0 - (count - warm) / max(total - warm, 1), 0.0)


def reference_steps(conf: dict, seed: int, device, gates0: np.ndarray, batches: Sequence[tuple],
                    opt: Dict) -> Dict:
    """Follow the program's first steps: batches are (ids [S], labels [S])
    of one sequence each; ``opt`` holds lr, warmup_steps, num_steps,
    reg_weight, b1, b2, eps, weight_decay, sink, recent. Returns each step's
    loss, the first gradient and the gates after each step."""
    no_tf32()
    shape = Shape.of(conf)
    top = {k: v.float() for k, v in make_top(shape, seed, device).items()}
    layers = [make_layer(shape, seed, li, device) for li in range(shape.layers)]
    gates = torch.tensor(gates0, dtype=torch.float32, device=device, requires_grad=True)
    m = torch.zeros_like(gates)
    v = torch.zeros_like(gates)
    out = {"loss": [], "gates": []}
    for k, (ids, labels) in enumerate(batches, start=1):
        labels = np.asarray(labels)
        sup = np.zeros(labels.shape[0], dtype=np.float32)
        sup[:-1] = labels[1:] != IGNORE
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
        loss = two_way_loss(layers, top, shape, gates, ids_t, torch.as_tensor(sup, device=device),
                            opt["sink"], opt["recent"], opt["reg_weight"])
        (g,) = torch.autograd.grad(loss, gates)
        if k == 1:
            out["grad1"] = g.cpu().numpy()
        out["loss"].append(float(loss.detach()))
        lr = learning_rate(opt, k - 1)
        with torch.no_grad():
            p = gates * (1.0 - lr * opt["weight_decay"])
            m = opt["b1"] * m + (1.0 - opt["b1"]) * g
            v = opt["b2"] * v + (1.0 - opt["b2"]) * g * g
            mh = m / (1.0 - opt["b1"] ** k)
            vh = v / (1.0 - opt["b2"] ** k)
            p = (p - lr * mh / (vh.sqrt() + opt["eps"])).clamp(0.0, 1.0)
        gates = p.detach().requires_grad_(True)
        out["gates"].append(p.cpu().numpy())
    return out
