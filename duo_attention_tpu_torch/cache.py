"""DuoAttention split KV cache (counterpart of duo_attention_tpu/cache.py).

* Full (retrieval) KV heads get a preallocated cache of ``max_cache_size``
  slots; slot j holds token j.
* Streaming KV heads get a sink buffer (slot s holds token s < sink; the
  trailing ``chunk`` rows are an overflow pad that is never visible) and a
  ring over global positions: slot g % R holds token g. Visibility is pure
  position arithmetic (the mask builders below), so nothing is ever copied
  to compact the window.

Layout is [batch, kv_head, slot, head_dim], as in the JAX package.

``DuoCacheQ4`` is the W8A8KV4 serving variant: the full-head cache is INT4,
token-paired (two tokens per byte row, byte for byte the JAX layout); the
streaming buffers stay in the cache's dtype, since they are O(sink + recent).

Unlike the JAX cache, which is immutable and threaded through jitted
functions, this cache is MUTATED: the write functions update the buffers in
place and return them, and ``models.llama.forward_chunk`` advances
``length`` in place (the same tensor, so a captured decode step advances it
on every replay).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .config import DuoConfig, ModelConfig
from .ops.inplace import (
    write_q4_token,
    write_q4_token_plain,
    write_row,
    write_row_plain,
    write_streaming_rows,
    write_streaming_rows_plain,
)
from .ops.quant import quantize_int4_paired
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


def _allocate(cfg: ModelConfig, duo: DuoConfig, batch_size: int, full_specs, dtype, dev,
              decode_only: bool, heads=None) -> dict:
    """{buffer name: [one zero tensor per layer]}: the full-head buffers named
    in full_specs as (name, shape after [B, Hf], dtype), and the four
    streaming buffers in ``dtype``. ``heads``: per-layer (full, streaming)
    KV head counts, when not the pattern's (a tensor-parallel rank's,
    ``parallel.mesh.cache_shardings``)."""
    if len(duo.num_full_kv_heads) != cfg.num_layers:
        raise ValueError(f"pattern has {len(duo.num_full_kv_heads)} layers, model has {cfg.num_layers}")
    if duo.max_cache_size % 128 != 0:
        raise ValueError(f"max_cache_size must be a multiple of 128 (got {duo.max_cache_size})")
    D = cfg.head_dim
    R, Ts = ring_capacity(duo, decode_only), sink_rows(duo, decode_only)
    stream_specs = [("k_sink", (Ts, D), dtype), ("v_sink", (Ts, D), dtype),
                    ("k_ring", (R, D), dtype), ("v_ring", (R, D), dtype)]
    if heads is None:
        heads = [(hf, cfg.num_kv_heads - hf) for hf in duo.num_full_kv_heads]
    if len(heads) != cfg.num_layers:
        raise ValueError(f"{len(heads)} layers of head counts for a model of {cfg.num_layers}")
    bufs = {name: [] for name, _, _ in (*full_specs, *stream_specs)}
    for hf, hs in heads:
        for specs, n in ((full_specs, hf), (stream_specs, hs)):
            for name, tail, dt in specs:
                bufs[name].append(torch.zeros((batch_size, n, *tail), dtype=dt, device=dev))
    return bufs


def init_cache(cfg: ModelConfig, duo: DuoConfig, batch_size: int,
               dtype=torch.bfloat16, device="cuda", decode_only: bool = False, heads=None) -> DuoCache:
    """Preallocate every layer's buffers (zeros) on ``device``. Raises when
    device is "cuda" and no GPU is present. ``heads``: per-layer (full,
    streaming) KV head counts of a tensor-parallel rank (default: the
    pattern's)."""
    dev = resolve_device(device)
    T, D = duo.max_cache_size, cfg.head_dim
    bufs = _allocate(cfg, duo, batch_size, [("k_full", (T, D), dtype), ("v_full", (T, D), dtype)],
                     dtype, dev, decode_only, heads)
    return DuoCache(**bufs, length=torch.zeros((), dtype=torch.int32, device=dev))


@dataclasses.dataclass
class DuoCacheQ4:
    """Like DuoCache, but the full-head cache is INT4, token-paired.

    k/v_full_q: [B, Hf_l, max_size // 2, D] uint8 — byte (r, d) =
        q4(token 2r, d) | q4(token 2r + 1, d) << 4
    k/v_full_s: [B, Hf_l, 4, max_size // 2] bfloat16 whatever ``dtype`` —
        rows (scale_even, scale_odd, zp_even, zp_odd). (The JAX cache pads
        each head to 8 rows for its compiler's tiling; rows 0-3 are these.)
    k/v_sink, k/v_ring, length: as in DuoCache.
    """

    k_full_q: List[torch.Tensor]
    v_full_q: List[torch.Tensor]
    k_full_s: List[torch.Tensor]
    v_full_s: List[torch.Tensor]
    k_sink: List[torch.Tensor]
    v_sink: List[torch.Tensor]
    k_ring: List[torch.Tensor]
    v_ring: List[torch.Tensor]
    length: torch.Tensor

    BUFFERS = ("k_full_q", "v_full_q", "k_full_s", "v_full_s", "k_sink", "v_sink", "k_ring", "v_ring")


def init_cache_q4(cfg: ModelConfig, duo: DuoConfig, batch_size: int,
                  dtype=torch.bfloat16, device="cuda", decode_only: bool = False, heads=None) -> DuoCacheQ4:
    """Preallocate the INT4 full-head buffers and the streaming buffers, all
    zeros (a never-written slot's scale must be finite: the masks hide the
    slot, not its arithmetic). The bf16 full cache is never allocated.
    ``heads`` as in ``init_cache``."""
    if cfg.head_dim % 2:
        raise ValueError(f"the INT4 cache needs an even head_dim (got {cfg.head_dim})")
    dev = resolve_device(device)
    T2, D = duo.max_cache_size // 2, cfg.head_dim
    full_specs = [("k_full_q", (T2, D), torch.uint8), ("v_full_q", (T2, D), torch.uint8),
                  ("k_full_s", (4, T2), torch.bfloat16), ("v_full_s", (4, T2), torch.bfloat16)]
    bufs = _allocate(cfg, duo, batch_size, full_specs, dtype, dev, decode_only, heads)
    return DuoCacheQ4(**bufs, length=torch.zeros((), dtype=torch.int32, device=dev))


def cache_constructor(kv_quant: str):
    """The constructor of the full-head cache format ``kv_quant`` names:
    "none" gives ``init_cache`` (the cache's dtype), "int4" ``init_cache_q4``.
    Anything else raises."""
    if kv_quant == "none":
        return init_cache
    if kv_quant == "int4":
        return init_cache_q4
    raise ValueError(f"kv_quant must be 'none' or 'int4', got {kv_quant!r}")


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


def write_full_pair(k_buf: torch.Tensor, v_buf: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                    start, plain: bool = False):
    """``write_full`` of a layer's K and V, in place; returns (k_buf, v_buf).

    S == 1 (decode) writes both rows in one ``write_row`` launch, which reads
    them by their strides (a ``transpose`` view of the projection's output
    needs no copy); S > 1 writes each as ``write_full`` does."""
    if k_in.shape[2] == 1:
        (write_row_plain if plain else write_row)(k_buf, k_in, start, v_buf, v_in)
        return k_buf, v_buf
    return write_full(k_buf, k_in, start, plain), write_full(v_buf, v_in, start, plain)


def write_full_q4(buf_q: torch.Tensor, buf_s: torch.Tensor, incoming: torch.Tensor, start,
                  plain: bool = False):
    """Quantize incoming [B, Hf, S, D] to INT4 and write it at token
    ``start`` of (buf_q [B, Hf, T/2, D] uint8, buf_s [B, Hf, 4, T/2] bf16), in
    place. Returns (buf_q, buf_s).

    S == 1 (decode) goes through ``write_q4_token`` (the kernel for a CUDA
    tensor; ``plain=True`` forces its plain version) at either parity, with
    start a scalar or [B]. S > 1 (prefill) takes an even S and a scalar start,
    which must be even: as in the JAX package the pair-row is ``start // 2``,
    clamped into [0, T/2 - S/2] like dynamic_update_slice, and an odd start is
    not rejected but lands one token early. Chunked prefill always starts
    even; the padded rows of a tail chunk are quantized and written, then
    overwritten by decode.
    """
    S, T2 = incoming.shape[2], buf_q.shape[2]
    if S == 1:
        return (write_q4_token_plain if plain else write_q4_token)(buf_q, buf_s, incoming, start)
    packed2, scales4 = quantize_int4_paired(incoming)
    r0 = _clamp_start(_scalar_start(start) // 2, S // 2, T2)
    buf_q[:, :, r0 : r0 + S // 2] = packed2
    buf_s[:, :, :, r0 : r0 + S // 2] = scales4.to(buf_s.dtype)
    return buf_q, buf_s


def write_full_q4_pair(k_q: torch.Tensor, k_s: torch.Tensor, v_q: torch.Tensor, v_s: torch.Tensor,
                       k_in: torch.Tensor, v_in: torch.Tensor, start, plain: bool = False):
    """``write_full_q4`` of a layer's K and V, in place; returns (k_q, k_s,
    v_q, v_s).

    S == 1 (decode) quantizes and writes both rows in one ``write_q4_token``
    launch, which reads them by their strides (a ``transpose`` view of the
    projection's output needs no copy); S > 1 writes each as
    ``write_full_q4`` does."""
    if k_in.shape[2] == 1:
        (write_q4_token_plain if plain else write_q4_token)(k_q, k_s, k_in, start, v_q, v_s, v_in)
        return k_q, k_s, v_q, v_s
    return (*write_full_q4(k_q, k_s, k_in, start, plain), *write_full_q4(v_q, v_s, v_in, start, plain))


def write_streaming(k_sink, v_sink, k_ring, v_ring, k_new, v_new, start, sink_size: int,
                    plain: bool = False):
    """Write a chunk [B, Hs, S, D] into the sink region (positionally, at
    min(start, sink)) and the ring (token g at slot g % R), in place.

    Tokens past the sink land in the never-visible overflow pad; every token
    also lands in the ring (masks de-duplicate by position). S == 1 goes
    through ``write_streaming_rows`` (kernel, or its plain version when
    ``plain``), which reads the rows by their strides (a ``transpose`` view
    of the projection's output needs no copy); S > 1 takes a scalar start.
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


def kv_memory_bytes(cache) -> int:
    """Bytes held by the KV buffers of a DuoCache or a DuoCacheQ4 (packed
    nibbles and scales included)."""
    return sum(t.numel() * t.element_size()
               for name in cache.BUFFERS for t in getattr(cache, name))
