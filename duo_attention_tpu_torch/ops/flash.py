"""Attention over the duo split KV cache.

Counterpart of duo_attention_tpu/ops/flash.py (``full_cache_attention``,
``full_cache_attention_q4``, ``streaming_cache_attention``). Each op has a
plain PyTorch version, which runs the float32 oracle of ops/attention_ref.py
on the same masks, and a CUDA kernel in ``csrc/flash.cu`` or
``csrc/flash_q4.cu`` (a prefill kernel for S > 1 and a decode kernel for
S == 1; the decode kernels split the keys over blocks and merge: the bf16
full-head decode by a partition each block works out on the device from the
lengths (``decode_partition``), the others by a plan made from host
integers, the bucket or the streaming window). The
wrapper takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; a launch failure raises. Counters:
``<wrapper>.prefill_launches`` and ``<wrapper>.decode_launches`` count
kernel launches, ``<plain>.cuda_calls`` counts plain calls on CUDA tensors.

Numerics of the kernels (the TPU kernels' own): the softmax scale is folded
into q in q's dtype, scores and the online softmax are float32, p is
rounded to bf16 before P.V, a row with no visible column gives 0. The
plain versions fold the scale the same way and are float32 from there on,
so a kernel and its plain version differ only by the rounding of p and of
the output; ``kernel_tolerance`` bounds that difference.

``full_cache_attention_q4`` reads the token-paired INT4 cache of
``cache.DuoCacheQ4``. Its kernels fold the dequantization into scores and
output (s = (q.Kq) scale_t + rowsum(q) zp_t, out = sum (p scale_t) Vq + sum
p zp_t) with ``p * scale_t`` rounded to bf16; its plain version dequantizes
the cache to float32 first. ``kernel_tolerance_q4`` bounds the difference.
"""

from __future__ import annotations

import ctypes

import torch

from ..cache import DuoCacheQ4, full_mask, ring_mask, sink_mask
from . import _build
from .attention_ref import masked_attention
from .inplace import device_positions, position_vector
from .quant import dequantize_int4_paired

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "full_cache_attention": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _I, _P],
    "decode_partial_floats": [_I, _I],
    "streaming_cache_attention": [
        _P, _P, _P, _P, _P, _P, _I, _P, _I, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
    ],
    "empty_kernel_launch": [_I, _I, _I, _P],
}
_Q4_SIGNATURES = {
    "full_cache_attention_q4": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                _P, _P, _I, _I, _P],
    "q4_decode_scratch_floats": [_I, _I, _I],
}
# The head_dims the kernels are instantiated for: 128 (every preset) and 64
# (the constructed circuits); any other raises on the card.
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # the decode kernel's largest query-head group
# Query rows per plain-version matmul: bounds its [Hq, rows, keys] f32 scores.
_PLAIN_ROWS = 512
# The INT4 decode kernel's split plan (``q4_decode_split_plan``): splits of
# whole Q4_DECODE_TILE_KEYS-key tiles, at most Q4_DECODE_WAVE_BLOCKS blocks per
# launch (one 256-thread block fits an H100 SM at the kernel's registers: 132
# run at once, and a second wave costs more than it brings) and at most
# Q4_DECODE_ONE_MERGE splits a (sequence, KV head) (the kernel's one merge
# gives each split's partial a lane of a warp). scripts/q4_decode_splits.py
# times other split sizes at the main path's shapes (PERF.md).
Q4_DECODE_TILE_KEYS, Q4_DECODE_WAVE_BLOCKS, Q4_DECODE_ONE_MERGE = 128, 132, 32
# The bf16 decode kernel's partition (``decode_partition``): the keys of every
# (sequence, KV head), cut into tiles of DECODE_TILE_KEYS, are laid end to end
# and shared out evenly over DECODE_BLOCKS_PER_SM blocks on each SM (the
# kernel's shared memory lets two stay resident); inside a block DECODE_WARPS
# warps take DECODE_CHUNK_KEYS keys at a time in turn.
DECODE_TILE_KEYS, DECODE_CHUNK_KEYS, DECODE_WARPS, DECODE_BLOCKS_PER_SM = 128, 16, 4, 2
# The streaming decode kernel's split plan (``stream_decode_split_plan``): a
# warp takes STREAM_DECODE_TILE_KEYS keys (one tile) of its block's split, a
# block at most STREAM_DECODE_MAX_WARPS warps, and a split aims at
# STREAM_DECODE_SPLIT_TILES tiles (the fastest size at the main path's window,
# chip_smoke.py's sweep); at most STREAM_DECODE_MAX_SPLITS splits a (sequence,
# streaming KV head), the blocks of one thread-block cluster, and about one
# wave of STREAM_DECODE_WAVE_BLOCKS blocks over all of them.
STREAM_DECODE_TILE_KEYS, STREAM_DECODE_MAX_WARPS, STREAM_DECODE_SPLIT_TILES = 16, 8, 4
STREAM_DECODE_MAX_SPLITS, STREAM_DECODE_WAVE_BLOCKS = 8, 132


def _lib():
    return _build.load("flash", _SIGNATURES)


def _lib_q4():
    return _build.load("flash_q4", _Q4_SIGNATURES)


def _span(bucket: int, T: int) -> int:
    """Keys the op may read: the engine's bucket (>= cs + S), or the buffer."""
    return T if bucket <= 0 else min(bucket, T)


def decode_grid(B: int, Hkv: int, span: int, sms: int) -> int:
    """Blocks of a bf16 decode launch: DECODE_BLOCKS_PER_SM on each of the
    card's ``sms`` SMs, or fewer where the bucket leaves fewer tiles over the
    B * Hkv (sequence, KV head) pairs. Made from host integers alone, never
    from the lengths on the device, so launching reads nothing back and a
    decode step captures into a CUDA graph that replays as lengths change."""
    return max(1, min(DECODE_BLOCKS_PER_SM * sms, B * Hkv * -(-max(span, 1) // DECODE_TILE_KEYS)))


def decode_row_keys(cs, valid, span: int) -> list:
    """Keys each sequence's full heads read at decode: min(cs + 1, span), or
    none where ``valid`` (None: every row) is 0. The kernel computes the same
    from the device's lengths."""
    valid = [1] * len(cs) if valid is None else valid
    return [min(int(c) + 1, span) if int(v) > 0 else 0 for c, v in zip(cs, valid)]


def _tile_starts(row_keys) -> list:
    """Tiles of one KV head of the rows before each row: [B + 1]."""
    starts = [0]
    for n in row_keys:
        starts.append(starts[-1] + -(-n // DECODE_TILE_KEYS))
    return starts


def decode_partition(row_keys, Hkv: int, nblocks: int) -> list:
    """The segments each block of the bf16 decode kernel reads, worked out as
    every block works them out on the device: [nblocks] lists of (b, hk,
    key_lo, key_hi).

    The (b, hk, tile) space of every pair's keys (``decode_row_keys``), in
    that order, is cut at p * total // used for p = 0..used, used =
    min(nblocks, total tiles): each block gets an equal share, to a tile, and
    none is left empty but those past ``used``. A block's range may cross
    (b, hk) boundaries: it writes one partial a pair it touches, at scratch
    slot block + b * Hkv + hk."""
    starts = _tile_starts(row_keys)
    total = Hkv * starts[-1]
    used = min(nblocks, total)
    blocks = []
    for p in range(used):
        t, t1 = p * total // used, (p + 1) * total // used
        segs, b = [], 0
        while t < t1:
            while Hkv * starts[b + 1] <= t:
                b += 1
            nt = starts[b + 1] - starts[b]
            hk, tile0 = divmod(t - Hkv * starts[b], nt)
            n = min(t1 - t, nt - tile0)
            segs.append((b, hk, tile0 * DECODE_TILE_KEYS, min((tile0 + n) * DECODE_TILE_KEYS, row_keys[b])))
            t += n
        blocks.append(segs)
    return blocks + [[] for _ in range(nblocks - used)]


def decode_merge_blocks(row_keys, Hkv: int, nblocks: int, b: int, hk: int) -> range:
    """The blocks whose partials the merge combines for pair (b, hk), in the
    order it combines them, found as the merge kernel finds them: the blocks
    whose share holds the pair's first and last tile, and every one between.
    Empty for a pair with no keys."""
    starts = _tile_starts(row_keys)
    total, n = Hkv * starts[-1], starts[b + 1] - starts[b]
    if n == 0:
        return range(0)
    used = min(nblocks, total)
    first = Hkv * starts[b] + hk * n
    return range(((first + 1) * used - 1) // total, ((first + n) * used - 1) // total + 1)


def q4_decode_split_plan(span: int, heads: int) -> tuple[int, int]:
    """(nsplit, split_keys) for the INT4 decode kernel over ``span`` keys and
    ``heads`` = B * Hkv (sequence, KV head) pairs: split s walks keys
    [s * split_keys, (s + 1) * split_keys).

    Made from the span alone (the engine's bucket), so a decode step
    captures into a CUDA graph; a sequence shorter than the span leaves its
    last splits empty, and the kernel skips them. Splits
    are whole tiles (``split_keys`` a multiple of 128: a pair row of two keys
    never straddles two splits) and ``nsplit * split_keys >= span``; as
    many splits as one wave of Q4_DECODE_WAVE_BLOCKS blocks over all pairs
    allows, and never more than Q4_DECODE_ONE_MERGE a pair."""
    tiles = -(-max(span, 1) // Q4_DECODE_TILE_KEYS)
    wanted = max(1, min(Q4_DECODE_WAVE_BLOCKS // max(heads, 1), Q4_DECODE_ONE_MERGE))  # splits a pair
    split_keys = -(-tiles // wanted) * Q4_DECODE_TILE_KEYS
    return -(-max(span, 1) // split_keys), split_keys


def stream_decode_split_plan(sink: int, recent: int, heads: int) -> tuple[int, int]:
    """(nsplit, split_keys) for the streaming decode kernel: split s walks
    keys [s * split_keys, (s + 1) * split_keys) of a (sequence, streaming KV
    head)'s visible range, which never holds more than sink + recent + 1 keys
    (``heads`` = B * Hs such pairs).

    Made from host integers alone (the DuoConfig's window and the head
    count), so launching reads nothing back and the decode step captures into
    a CUDA graph; splits past a short sequence's frontier stay empty. Splits
    of about STREAM_DECODE_SPLIT_TILES whole tiles, no more than one wave of
    STREAM_DECODE_WAVE_BLOCKS blocks allows and at most
    STREAM_DECODE_MAX_SPLITS (the kernel's cluster), none left empty by the
    plan itself."""
    tile = STREAM_DECODE_TILE_KEYS
    tiles = -(-(sink + recent + 1) // tile)
    nsplit = max(1, min(STREAM_DECODE_MAX_SPLITS, -(-tiles // STREAM_DECODE_SPLIT_TILES),
                        STREAM_DECODE_WAVE_BLOCKS // max(heads, 1)))
    per_split = -(-tiles // nsplit)
    return -(-tiles // per_split), per_split * tile


_decode_scratch = {}


def _scratch(kind: str, numel: int, dtype, device) -> torch.Tensor:
    """A buffer kept per (kind, size, device) and reused by every call: the
    full-head decode kernels' partials, and the INT4 decode's ticket counters,
    which start at 0 and which each launch leaves at 0. Never freed, so a CUDA
    graph that captured one stays valid."""
    key = (kind, numel, str(device))
    if key not in _decode_scratch:
        _decode_scratch[key] = torch.zeros(numel, dtype=dtype, device=device)
    return _decode_scratch[key]


def _check_kernel_inputs(name: str, q: torch.Tensor, bufs, Hkv: int) -> None:
    for t in (q, *bufs):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                f"{name}: CUDA kernel takes contiguous bfloat16 tensors on one device, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    B, S, Hq, D = q.shape
    if D not in HEAD_DIMS or Hq % Hkv != 0:
        raise ValueError(f"{name}: kernel needs head_dim in {HEAD_DIMS} and Hq % Hkv == 0, "
                         f"got q {tuple(q.shape)} with {Hkv} KV heads")
    if S == 1 and Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{name}: decode kernel takes at most {MAX_GROUP} query heads per KV head")


def kernel_tolerance(plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for the attention outputs:
    2^-7 |plain| + 2^-6 rms(plain over the row's D).

    Both round their output to bf16, which puts them at most one ulp, 2^-7
    |plain|, apart. The kernel also rounds each p to bf16 (relative error
    <= 2^-8) before P.V; that error has random signs and is about 2^-8/2 of
    the row's rms, so 2^-6 rms leaves room for its largest value over
    millions of elements. A dropped or extra key of weight w moves the row
    by about w times its rms, so such faults show once w passes ~2^-6."""
    p = plain.float()
    rms = p.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return 2.0**-7 * p.abs() + 2.0**-6 * rms


def _plain_tiles(q, k_cat, v_cat, mask_fn):
    """masked_attention per sequence and per block of query rows, with the
    softmax scale folded into q in q's dtype as the kernels fold it.

    k_cat/v_cat [B, Hkv, T, D]; mask_fn(b, rows) -> [len(rows), T] bool."""
    B, S = q.shape[:2]
    out = torch.empty_like(q)
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    q = q * scale
    for b in range(B):
        kb = k_cat[b : b + 1].transpose(1, 2)
        vb = v_cat[b : b + 1].transpose(1, 2)
        for s0 in range(0, S, _PLAIN_ROWS):
            rows = torch.arange(s0, min(s0 + _PLAIN_ROWS, S), device=q.device)
            mask = mask_fn(b, rows)[None, None]
            out[b : b + 1, s0 : s0 + len(rows)] = masked_attention(
                q[b : b + 1, s0 : s0 + len(rows)], kb, vb, mask, scale=1.0
            )
    return out


# ---------------------------------------------------------------------------
# Full (retrieval) heads
# ---------------------------------------------------------------------------


def full_cache_attention_plain(q, k, v, cs, *, bucket: int = 0, valid=None):
    """Plain version: the float32 oracle with mask ``slot <= qpos`` over the
    first ``span`` slots; a row whose ``valid`` is 0 sees no slot and is 0."""
    if q.is_cuda:
        full_cache_attention_plain.cuda_calls += 1
    B, S = q.shape[:2]
    span = _span(bucket, k.shape[2])
    cs = position_vector(cs, B, q.device)
    live = None if valid is None else position_vector(valid, B, q.device) > 0
    return _plain_tiles(
        q, k[:, :, :span], v[:, :, :span],
        lambda b, rows: full_mask(cs[b] + rows, span) & (True if live is None else live[b]),
    )


full_cache_attention_plain.cuda_calls = 0

def full_cache_attention(q, k, v, cs, *, bucket: int = 0, valid=None):
    """Attention of incoming queries over the full-head cache.

    q [B, S, Hq, D] (post-RoPE); k/v [B, Hkv, T, D] already holding the chunk
    at [cs, cs+S); cs int, 0-d or [B] tensor (each sequence's cache length
    before the chunk). Slot j is visible to query position qpos iff
    j <= qpos. bucket: a bound >= max(cs) + S on the slots read (0: the
    whole buffer). valid: None (every row) or an int, 0-d or [B] tensor, the
    real queries of each row; a row whose valid is 0 reads no key and gives 0
    (the kernels take it at decode only). Returns [B, S, Hq, D].
    """
    if not q.is_cuda:
        return full_cache_attention_plain(q, k, v, cs, bucket=bucket, valid=valid)
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    _check_kernel_inputs("full_cache_attention", q, (k, v), Hkv)
    if tuple(k.shape) != (B, Hkv, T, D) or tuple(v.shape) != (B, Hkv, T, D):
        raise ValueError(f"full_cache_attention: k {tuple(k.shape)} v {tuple(v.shape)} for q {tuple(q.shape)}")
    if valid is not None and S != 1:
        raise ValueError("full_cache_attention: the prefill kernel takes no valid counts")
    cs_t, cs_stride = device_positions(cs, B, q.device)
    valid_t, valid_stride = (None, 0) if valid is None else device_positions(valid, B, q.device)
    span = _span(bucket, T)
    out = torch.empty_like(q)
    lib = _lib()
    part, nblocks = None, 0
    if S == 1:  # a (acc, m, l) partial a block and a pair it touches: slot block + b * Hkv + hk
        nblocks = decode_grid(B, Hkv, span, torch.cuda.get_device_properties(q.device).multi_processor_count)
        part = _scratch("part", (nblocks + B * Hkv) * lib.decode_partial_floats(Hq // Hkv, D), torch.float32,
                        q.device)
    err = lib.full_cache_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cs_t.data_ptr(), cs_stride,
        None if valid_t is None else valid_t.data_ptr(), valid_stride, out.data_ptr(),
        B, S, Hq, Hkv, T, span, D, D**-0.5, None if part is None else part.data_ptr(), nblocks,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "full_cache_attention")
    if S == 1:
        full_cache_attention.decode_launches += 1
    else:
        full_cache_attention.prefill_launches += 1
    return out


full_cache_attention.prefill_launches = 0
full_cache_attention.decode_launches = 0


# ---------------------------------------------------------------------------
# Full heads over the INT4 cache
# ---------------------------------------------------------------------------


def kernel_tolerance_q4(plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for ``full_cache_attention_q4``:
    2^-7 |plain| + 2^-4 rms(plain over the row's D).

    Derived as ``kernel_tolerance``. The first term is the one bf16 ulp
    between two outputs that each round to bf16. The second covers the
    rounding of p * scale_t to bf16 (relative error <= 2^-8, random sign per
    key), which here multiplies the NIBBLES: key t's error is that fraction of
    p_t (V_t - min_t), not of p_t V_t. V_t - min_t is never negative and is as
    large as the row's range, so for a row of 128 Gaussian channels (min about
    -2.6 sigma) its rms is about 2.8 times the rms of V_t itself. The bf16
    bound's 2^-6 rms is therefore widened by 4, to 2^-4 rms. A dropped or
    extra key of weight w still moves the row by about w times its rms, so
    such faults show once w passes ~2^-4."""
    p = plain.float()
    rms = p.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return 2.0**-7 * p.abs() + 2.0**-4 * rms


def full_cache_attention_q4_plain(q, k_packed, k_scales, v_packed, v_scales, cs, *, bucket: int = 0):
    """Plain version: dequantize the first ``span`` slots to float32
    (``dequantize_int4_paired``), then the float32 oracle with mask
    ``slot <= qpos``."""
    if q.is_cuda:
        full_cache_attention_q4_plain.cuda_calls += 1
    B = q.shape[0]
    span = _span(bucket, 2 * k_packed.shape[2])
    rows = (span + 1) // 2
    k = dequantize_int4_paired(k_packed[:, :, :rows], k_scales[..., :rows])[:, :, :span]
    v = dequantize_int4_paired(v_packed[:, :, :rows], v_scales[..., :rows])[:, :, :span]
    cs = position_vector(cs, B, q.device)
    return _plain_tiles(q, k, v, lambda b, r: full_mask(cs[b] + r, span))


full_cache_attention_q4_plain.cuda_calls = 0


def full_cache_attention_q4(q, k_packed, k_scales, v_packed, v_scales, cs, *, bucket: int = 0):
    """``full_cache_attention`` over the token-paired INT4 cache, with the
    dequantization folded into the kernel.

    q [B, S, Hq, D] (post-RoPE); k/v_packed [B, Hkv, T/2, D] uint8 (byte
    (r, d) = q4(token 2r, d) | q4(token 2r+1, d) << 4) and k/v_scales
    [B, Hkv, 4, T/2] bfloat16 (rows scale_even, scale_odd, zp_even, zp_odd),
    already holding the chunk at [cs, cs+S); cs and bucket as in
    ``full_cache_attention``. Returns [B, S, Hq, D].
    """
    if not q.is_cuda:
        return full_cache_attention_q4_plain(q, k_packed, k_scales, v_packed, v_scales, cs, bucket=bucket)
    B, S, Hq, D = q.shape
    Hkv, T2 = k_packed.shape[1], k_packed.shape[2]
    _check_kernel_inputs("full_cache_attention_q4", q, (k_scales, v_scales), Hkv)
    for t in (k_packed, v_packed):
        if (t.device != q.device or t.dtype != torch.uint8 or not t.is_contiguous()
                or tuple(t.shape) != (B, Hkv, T2, D)):
            raise ValueError(f"full_cache_attention_q4: packed cache must be contiguous uint8 "
                             f"[{B}, {Hkv}, {T2}, {D}] on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if tuple(k_scales.shape) != (B, Hkv, 4, T2) or tuple(v_scales.shape) != (B, Hkv, 4, T2):
        raise ValueError(f"full_cache_attention_q4: scales {tuple(k_scales.shape)} {tuple(v_scales.shape)}, "
                         f"expected {(B, Hkv, 4, T2)}")
    if S == 1 and T2 % 8 != 0:
        raise ValueError(f"full_cache_attention_q4: the decode kernel needs T/2 = {T2} a multiple of 8")
    cs_t, cs_stride = device_positions(cs, B, q.device)
    span = _span(bucket, 2 * T2)
    out = torch.empty_like(q)
    lib = _lib_q4()
    part = counters = None
    nsplit = split_keys = 0
    if S == 1:
        nsplit, split_keys = q4_decode_split_plan(span, B * Hkv)
        part = _scratch("q4_part", B * Hkv * lib.q4_decode_scratch_floats(nsplit, Hq // Hkv, D),
                        torch.float32, q.device)
        counters = _scratch("q4_tickets", B * Hkv, torch.int32, q.device)  # one ticket counter a (b, KV head)
    err = lib.full_cache_attention_q4(
        q.data_ptr(), k_packed.data_ptr(), k_scales.data_ptr(), v_packed.data_ptr(), v_scales.data_ptr(),
        cs_t.data_ptr(), cs_stride, out.data_ptr(), B, S, Hq, Hkv, T2, span, D, D**-0.5,
        None if part is None else part.data_ptr(), None if counters is None else counters.data_ptr(),
        nsplit, split_keys, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "full_cache_attention_q4")
    if S == 1:
        full_cache_attention_q4.decode_launches += 1
    else:
        full_cache_attention_q4.prefill_launches += 1
    return out


full_cache_attention_q4.prefill_launches = 0
full_cache_attention_q4.decode_launches = 0


def decode_reads_freed_rows(cache) -> bool:
    """Whether the full-head decode of ``cache``'s format reads the keys of
    a row the step's valid counts mark empty (a freed serving slot). The bf16
    decode (``full_cache_attention``) takes the counts and skips such a row;
    the INT4 decode (``full_cache_attention_q4``) takes none and reads the
    row up to its length, capped at the bucket."""
    return isinstance(cache, DuoCacheQ4)


# ---------------------------------------------------------------------------
# Streaming heads (sink buffer + position ring)
# ---------------------------------------------------------------------------


def streaming_cache_attention_plain(q, k_sink, v_sink, k_ring, v_ring, cs, total_after,
                                    sink_size: int, recent_size: int):
    """Plain version: the float32 oracle over [sink slots | ring slots] with
    the sink and ring masks of cache.py."""
    if q.is_cuda:
        streaming_cache_attention_plain.cuda_calls += 1
    B, S = q.shape[:2]
    R = k_ring.shape[2]
    cs = position_vector(cs, B, q.device)
    total = position_vector(total_after, B, q.device)
    k_cat = torch.cat([k_sink[:, :, :sink_size], k_ring], dim=2)
    v_cat = torch.cat([v_sink[:, :, :sink_size], v_ring], dim=2)

    def mask_fn(b, rows):
        qpos = cs[b] + rows
        return torch.cat([
            sink_mask(qpos, sink_size, sink_size),
            ring_mask(qpos, R, total[b], cs[b], sink_size, recent_size),
        ], dim=-1)

    return _plain_tiles(q, k_cat, v_cat, mask_fn)


streaming_cache_attention_plain.cuda_calls = 0


def streaming_cache_attention(q, k_sink, v_sink, k_ring, v_ring, cs, total_after,
                              sink_size: int, recent_size: int):
    """Streaming-head attention over the sink buffer and the position ring.

    q [B, S, Hsq, D]; k/v_sink [B, Hs, sink + C, D]; k/v_ring [B, Hs, R, D],
    all already holding the chunk. cs / total_after: int, 0-d or [B] tensor
    (chunk start, and tokens after the chunk including its padding). A sink
    slot s is visible iff s < sink and s <= qpos; a ring slot holding token g
    iff g >= sink, g >= max(cs - recent, 0), g <= qpos and g >= 0.
    Returns [B, S, Hsq, D].
    """
    if not q.is_cuda:
        return streaming_cache_attention_plain(
            q, k_sink, v_sink, k_ring, v_ring, cs, total_after, sink_size, recent_size
        )
    B, S, Hq, D = q.shape
    Hs, Ts, R = k_sink.shape[1], k_sink.shape[2], k_ring.shape[2]
    _check_kernel_inputs("streaming_cache_attention", q, (k_sink, v_sink, k_ring, v_ring), Hs)
    if (tuple(v_sink.shape) != (B, Hs, Ts, D) or tuple(k_ring.shape) != (B, Hs, R, D)
            or tuple(v_ring.shape) != (B, Hs, R, D) or not 0 <= sink_size <= Ts):
        raise ValueError("streaming_cache_attention: inconsistent buffer shapes")
    cs_t, cs_stride = device_positions(cs, B, q.device)
    tot_t, tot_stride = device_positions(total_after, B, q.device)
    out = torch.empty_like(q)
    lib = _lib()
    nsplit, split_keys = stream_decode_split_plan(sink_size, recent_size, B * Hs) if S == 1 else (0, 0)
    err = lib.streaming_cache_attention(
        q.data_ptr(), k_sink.data_ptr(), v_sink.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(),
        cs_t.data_ptr(), cs_stride, tot_t.data_ptr(), tot_stride, out.data_ptr(),
        B, S, Hq, Hs, Ts, R, D, sink_size, recent_size, D**-0.5, nsplit, split_keys,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "streaming_cache_attention")
    if S == 1:
        streaming_cache_attention.decode_launches += 1
    else:
        streaming_cache_attention.prefill_launches += 1
    return out


streaming_cache_attention.prefill_launches = 0
streaming_cache_attention.decode_launches = 0
