"""Attention on a rank's KV heads (counterpart of duo_attention_tpu/parallel/spmd.py).

JAX runs each Pallas kernel inside ``shard_map`` so that every device keeps
only its KV-head slice of the cache and attends with the query heads of that
slice, with no cross-device traffic. Here a rank already holds only its
slice (``mesh.shard_params`` gives it the projections of its heads,
``cache_shardings`` the cache of its heads), so each wrapper only checks the
local shapes and calls ``ops/flash.py`` on them: kernels 1, 2 and 6 of the
port run inside, at the local head counts. The wo all_reduce that follows is
``models/llama.py``'s.
"""

from __future__ import annotations

import torch

from ..ops import flash


def can_shard_heads(mesh, n_heads: int) -> bool:
    """Whether a group of ``n_heads`` KV heads splits over the mesh's tensor
    axis. Unlike JAX's, a tensor axis of 1 and a zero count count as split:
    the layer then takes the mesh path, collectives included (so a one-rank
    NCCL mesh captures them), on all of its heads."""
    return mesh is not None and n_heads % mesh.tensor == 0


def _check(name: str, q: torch.Tensor, *bufs: torch.Tensor) -> None:
    B, Hq = q.shape[0], q.shape[2]
    Hkv = bufs[0].shape[1]
    if Hkv == 0 or Hq % Hkv or any(t.shape[0] != B or t.shape[1] != Hkv for t in bufs):
        raise ValueError(f"{name}: local q {tuple(q.shape)} against local buffers "
                         f"{[tuple(t.shape) for t in bufs]}: the rank's query heads must be a multiple of its "
                         "KV heads, its batch rows the cache's")


def sharded_full_attention(mesh, q, k, v, cs, *, bucket: int = 0, plain: bool = False):
    """``flash.full_cache_attention`` on the rank's full heads: q [B, S,
    hf_local * G, D], k/v [B, hf_local, T, D]."""
    _check("sharded_full_attention", q, k, v)
    fn = flash.full_cache_attention_plain if plain else flash.full_cache_attention
    return fn(q, k, v, cs, bucket=bucket)


def sharded_full_attention_q4(mesh, q, k_packed, k_scales, v_packed, v_scales, cs, *, bucket: int = 0,
                              plain: bool = False):
    """``flash.full_cache_attention_q4`` on the rank's full heads (packed
    [B, hf_local, T/2, D], scales [B, hf_local, 4, T/2])."""
    _check("sharded_full_attention_q4", q, k_packed, k_scales, v_packed, v_scales)
    fn = flash.full_cache_attention_q4_plain if plain else flash.full_cache_attention_q4
    return fn(q, k_packed, k_scales, v_packed, v_scales, cs, bucket=bucket)


def sharded_streaming_attention(mesh, q, k_sink, v_sink, k_ring, v_ring, cs, total_after,
                                sink_size: int, recent_size: int, plain: bool = False):
    """``flash.streaming_cache_attention`` on the rank's streaming heads."""
    _check("sharded_streaming_attention", q, k_sink, v_sink, k_ring, v_ring)
    fn = flash.streaming_cache_attention_plain if plain else flash.streaming_cache_attention
    return fn(q, k_sink, v_sink, k_ring, v_ring, cs, total_after, sink_size, recent_size)
