"""DuoAttention split KV cache (bf16 part of duo_attention_tpu/cache.py).

* Full (retrieval) KV heads get a preallocated cache of ``max_cache_size``
  slots; slot j holds token j.
* Streaming KV heads get a sink buffer (slot s holds token s < sink; the
  trailing ``chunk`` rows are an overflow pad that is never visible) and a
  ring over global positions: slot g % R holds token g. Visibility is pure
  position arithmetic (the mask builders below), so nothing is ever copied
  to compact the window.

Layout is [batch, kv_head, slot, head_dim], as in the JAX package.

Unlike the JAX cache, which is immutable and threaded through jitted
functions, this cache is MUTATED: the write functions update the buffers in
place and return them, and ``models.llama.forward_chunk`` advances
``length`` on the object it was given.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .config import DuoConfig, ModelConfig
from .ops.inplace import write_row, write_row_plain, write_streaming_rows, write_streaming_rows_plain
from .utils import resolve_device


@dataclasses.dataclass
class DuoCache:
    """Per-layer lists (layers have heterogeneous head splits).

    k_full/v_full: [B, Hf_l, max_size, D]
    k_sink/v_sink: [B, Hs_l, sink + chunk, D]
    k_ring/v_ring: [B, Hs_l, R, D] with R = round_up(recent + chunk, 512)
    length: int32 tensor on the cache's device, 0-d, or [B] when every
        sequence has its own length — the real tokens absorbed so far.
    """

    k_full: List[torch.Tensor]
    v_full: List[torch.Tensor]
    k_sink: List[torch.Tensor]
    v_sink: List[torch.Tensor]
    k_ring: List[torch.Tensor]
    v_ring: List[torch.Tensor]
    length: torch.Tensor

    BUFFERS = ("k_full", "v_full", "k_sink", "v_sink", "k_ring", "v_ring")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def ring_capacity(duo: DuoConfig, decode_only: bool = False) -> int:
    """Ring rows: recent + chunk live at once for chunked prefill (queries at
    a chunk's end see the window as of chunk start); recent + 1 suffices for
    a decode-only cache. Rounded up (512, or 128 decode-only) as in JAX."""
    if decode_only:
        return _round_up(duo.recent_size + 8, 128)
    return _round_up(duo.recent_size + duo.prefill_chunk_size, 512)


def sink_rows(duo: DuoConfig, decode_only: bool = False) -> int:
    """Sink buffer rows: the sink plus an overflow pad that absorbs a whole
    prefill chunk (or one decode row)."""
    if decode_only:
        return _round_up(duo.sink_size + 8, 8)
    return duo.sink_size + duo.prefill_chunk_size


def init_cache(cfg: ModelConfig, duo: DuoConfig, batch_size: int,
               dtype=torch.bfloat16, device="cuda", decode_only: bool = False) -> DuoCache:
    """Preallocate every layer's buffers (zeros) on ``device``. Raises when
    device is "cuda" and no GPU is present."""
    if len(duo.num_full_kv_heads) != cfg.num_layers:
        raise ValueError(f"pattern has {len(duo.num_full_kv_heads)} layers, model has {cfg.num_layers}")
    if duo.max_cache_size % 128 != 0:
        raise ValueError(f"max_cache_size must be a multiple of 128 (got {duo.max_cache_size})")
    dev = resolve_device(device)
    D = cfg.head_dim
    R = ring_capacity(duo, decode_only)
    Ts = sink_rows(duo, decode_only)
    bufs = {name: [] for name in DuoCache.BUFFERS}
    for hf in duo.num_full_kv_heads:
        hs = cfg.num_kv_heads - hf
        for name, rows, heads in (("k_full", duo.max_cache_size, hf), ("v_full", duo.max_cache_size, hf),
                                  ("k_sink", Ts, hs), ("v_sink", Ts, hs),
                                  ("k_ring", R, hs), ("v_ring", R, hs)):
            bufs[name].append(torch.zeros((batch_size, heads, rows, D), dtype=dtype, device=dev))
    return DuoCache(**bufs, length=torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Writes (in place)
# ---------------------------------------------------------------------------


def _scalar_start(start) -> int:
    start = torch.as_tensor(start)
    if start.dim() != 0:
        raise ValueError("ragged prefill writes are unsupported: start must be a scalar")
    return int(start)


def _clamp_start(start: int, S: int, T: int) -> int:
    """A chunk write's first slot, clamped into [0, T - S] as JAX's
    dynamic_update_slice clamps its start."""
    return min(max(start, 0), T - S)


def write_full(buf: torch.Tensor, incoming: torch.Tensor, start, plain: bool = False) -> torch.Tensor:
    """Write incoming [B, Hf, S, D] at slot ``start`` of buf, in place.

    S == 1 (decode) goes through ``write_row`` (the kernel for a CUDA tensor;
    ``plain=True`` forces its plain version), with start a scalar or [B].
    S > 1 (prefill) takes a scalar start, clamped like dynamic_update_slice.
    """
    S, T = incoming.shape[2], buf.shape[2]
    if S == 1:
        return (write_row_plain if plain else write_row)(buf, incoming, start)
    st = _clamp_start(_scalar_start(start), S, T)
    buf[:, :, st : st + S] = incoming
    return buf


def write_streaming(k_sink, v_sink, k_ring, v_ring, k_new, v_new, start, sink_size: int,
                    plain: bool = False):
    """Write a chunk [B, Hs, S, D] into the sink region (positionally, at
    min(start, sink)) and the ring (token g at slot g % R), in place.

    Tokens past the sink land in the never-visible overflow pad; every token
    also lands in the ring (masks de-duplicate by position). S == 1 goes
    through ``write_streaming_rows`` (kernel, or its plain version when
    ``plain``); S > 1 takes a scalar start.
    """
    S = k_new.shape[2]
    R = k_ring.shape[2]
    if S == 1:
        fn = write_streaming_rows_plain if plain else write_streaming_rows
        return fn(k_sink, v_sink, k_ring, v_ring, k_new, v_new, start, sink_size)
    first = _scalar_start(start)
    off = _clamp_start(min(first, sink_size), S, k_sink.shape[2])
    k_sink[:, :, off : off + S] = k_new
    v_sink[:, :, off : off + S] = v_new
    idx = torch.remainder(first + torch.arange(S, device=k_ring.device), R)
    k_ring.index_copy_(2, idx, k_new.to(k_ring.dtype))
    v_ring.index_copy_(2, idx, v_new.to(v_ring.dtype))
    return k_sink, v_sink, k_ring, v_ring


# ---------------------------------------------------------------------------
# Mask builders (position arithmetic)
# ---------------------------------------------------------------------------


def ring_slot_positions(R: int, total_after) -> torch.Tensor:
    """Global position of the latest token written at each ring slot: slot s
    holds the largest g = s (mod R) with g < total_after; never-written slots
    get negative g. total_after: int, 0-d or [B] -> [R] or [B, R] int."""
    t = torch.as_tensor(total_after)
    s = torch.arange(R, device=t.device)
    t = t[..., None]
    return t - 1 - torch.remainder(t - 1 - s, R)


def full_mask(q_positions: torch.Tensor, buf_len: int) -> torch.Tensor:
    """Full-head mask: slot j visible iff j <= qpos. [S] or [B, S] positions
    -> [S, buf_len] or [B, S, buf_len] bool."""
    j = torch.arange(buf_len, device=q_positions.device)
    return j <= q_positions[..., None]


def sink_mask(q_positions: torch.Tensor, buf_len: int, sink_size: int) -> torch.Tensor:
    """Mask over the sink buffer (slot s holds token s); shapes as full_mask."""
    s = torch.arange(buf_len, device=q_positions.device)
    return (s < sink_size) & (s <= q_positions[..., None])


def ring_mask(q_positions: torch.Tensor, R: int, total_after, chunk_start,
              sink_size: int, recent_size: int) -> torch.Tensor:
    """Mask over the ring: [S, R], or [B, S, R] for [B, S] positions.

    Visible iff the slot's token g satisfies g >= sink (sink tokens are seen
    in the sink region), g >= max(chunk_start - recent, 0) (the window as of
    chunk start), g <= qpos and g >= 0 (the slot was written).
    """
    dev = q_positions.device
    g = ring_slot_positions(R, torch.as_tensor(total_after, device=dev))[..., None, :]
    qp = q_positions[..., :, None]
    window_lo = torch.clamp(torch.as_tensor(chunk_start, device=dev) - recent_size, min=0)
    if window_lo.dim():
        window_lo = window_lo[..., None, None]
    return (g >= sink_size) & (g >= window_lo) & (g <= qp) & (g >= 0)


def kv_memory_bytes(cache: DuoCache) -> int:
    """Bytes held by the cache's KV buffers."""
    return sum(t.numel() * t.element_size()
               for name in DuoCache.BUFFERS for t in getattr(cache, name))
