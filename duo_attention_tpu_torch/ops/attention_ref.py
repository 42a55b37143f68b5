"""Reference attention: masks and masked GQA attention in float32.

Counterpart of duo_attention_tpu/ops/attention_ref.py: the slow but obvious
oracle the kernels' plain versions and the model tests are held against.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def cached_chunk_mask(q_len: int, buf_len: int, base_len, device=None) -> torch.Tensor:
    """Query i attends slot j iff j <= base_len + i: all cached tokens plus
    causal over the incoming chunk. Returns [q_len, buf_len] bool."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(buf_len, device=device)[None, :]
    return j <= base_len + i


def masked_attention(q, k, v, mask, scale=None):
    """GQA attention with an explicit boolean mask and float32 softmax.

    q [B, S, Hq, D]; k/v [B, T, Hkv, D]; mask broadcastable to
    [B, Hq, S, T] (True = attend). A row with no visible column gives 0.
    Returns [B, S, Hq, D] in q's dtype.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D**0.5)
    qf = q.float().transpose(1, 2)  # [B, Hq, S, D]
    kf = k.float().transpose(1, 2)  # [B, Hkv, T, D]
    vf = v.float().transpose(1, 2)
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=1)
        vf = vf.repeat_interleave(groups, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    weights = torch.where(mask.any(dim=-1, keepdim=True), weights, torch.zeros_like(weights))
    out = torch.einsum("bhst,bhtd->bhsd", weights, vf)
    return out.transpose(1, 2).to(q.dtype)


def causal_attention_ref(q, k, v, scale=None):
    """Plain causal attention (the gates = 1 oracle)."""
    S = q.shape[1]
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    return masked_attention(q, k, v, (j <= i)[None, None], scale)
