"""Blockwise differentiable attention: the training compute path.

Counterpart of duo_attention_tpu/ops/blockwise.py. Gate training needs
gradients through full causal and Λ-masked attention; this is one function
for both (``mask_fn``): a loop over KV blocks with an online softmax in
float32, each block body under ``torch.utils.checkpoint`` when ``remat`` is
set (the JAX ``jax.checkpoint`` on the scan body), so the backward keeps a
block's carries and recomputes its scores.

Plain PyTorch on any device, with JAX's arithmetic step for step: q, k and v
in float32, masked scores set to ``NEG_INF``, p zeroed where masked, an
empty row's sum taken as 1, global positions from ``q_offset`` and
``k_offset``. It is not SDPA, which does not compute this float32 function,
and it needs TF32 off (PyTorch's default) to compute on the card what the
CPU tests hold.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask_fn(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    return k_pos[None, :] <= q_pos[:, None]


def lambda_mask_fn(sink_size: int, recent_size: int) -> Callable:
    """Λ-mask: causal and (sink or recent)."""

    def fn(q_pos, k_pos):
        causal = k_pos[None, :] <= q_pos[:, None]
        sink = k_pos[None, :] < sink_size
        recent = k_pos[None, :] >= q_pos[:, None] - recent_size + 1
        return causal & (sink | recent)

    return fn


def _block(qf, k_blk, v_blk, m_prev, l_prev, acc, mask, scale):
    """One KV block of the online softmax; returns the new (m, l, acc)."""
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k_blk.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    # p is 0 where masked, with no gradient there, as JAX's where after its exp
    p = torch.exp(torch.where(mask, s - m_next, float("-inf")))
    alpha = torch.exp(m_prev - m_next)
    l_next = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", p, v_blk.float())
    return m_next, l_next, acc


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_fn: Callable,
                        q_offset: int = 0, k_offset: int = 0, block_k: int = 512,
                        remat: bool = True) -> torch.Tensor:
    """Masked GQA attention over KV blocks.

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D]. ``mask_fn(q_pos, k_pos)`` gives
    the bool [Sq, bk] mask from global positions (the offsets place a
    sequence shard). Returns [B, Sq, Hq, D] in q's dtype; softmax stats in
    float32."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)
    bk = min(block_k, Skv)
    n_blocks = -(-Skv // bk)
    dev = q.device
    # [B, Hkv, G, Sq, D] query layout; k and v as [B, Hkv, Skv, D]
    qf = q.float().transpose(1, 2).reshape(B, Hkv, G, Sq, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    body = remat and torch.is_grad_enabled()
    idx = torch.arange(bk, dtype=torch.int32, device=dev)
    for j in range(n_blocks):
        lo, hi = j * bk, min((j + 1) * bk, Skv)
        k_pos = k_offset + lo + idx
        # the last block's tail past Skv: JAX pads k and v with zeros and masks it
        mask = (mask_fn(q_pos, k_pos) & (lo + idx < Skv)[None, :])[None, None, None]
        k_blk, v_blk = kt[:, :, lo:hi], vt[:, :, lo:hi]
        if hi - lo < bk:
            pad = (0, 0, 0, bk - (hi - lo))
            k_blk, v_blk = torch.nn.functional.pad(k_blk, pad), torch.nn.functional.pad(v_blk, pad)
        if body:
            m, l, acc = checkpoint(_block, qf, k_blk, v_blk, m, l, acc, mask, scale, use_reentrant=False)
        else:
            m, l, acc = _block(qf, k_blk, v_blk, m, l, acc, mask, scale)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(B, Hq, Sq, D).transpose(1, 2)
    return out.to(q.dtype)
