"""In-place single-row cache writes of the decode step.

Counterpart of duo_attention_tpu/ops/inplace.py. Unlike the JAX functions,
which return updated buffers, these MUTATE the cache tensors they are given
and return them. Each has a plain PyTorch version (used for CPU tensors and
as the reference on the card) and a CUDA kernel in ``csrc/inplace.cu``
(used for CUDA tensors; a launch failure raises). The wrappers count their
launches in ``<wrapper>.launches``; the plain versions count calls made
with CUDA tensors in ``<plain>.cuda_calls``.

``write_row`` takes the full heads' K row and V row of a layer in one
launch, read in place by their strides from the projection's output;
``write_streaming_rows`` does the same for the streaming heads.
``write_q4_token`` is the INT4 cache's decode write: it quantizes the row and
merges its nibbles into the token-paired byte row in one kernel, and, like
``write_row``, takes a layer's K and V rows in one launch, read in place.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quant import quantize_int4_nibbles

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "write_row": [_P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P],
    "write_streaming_rows": [_P, _P, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "write_q4_token": [_P, _P, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P],
}


def _lib():
    return _build.load("inplace", _SIGNATURES)


def position_vector(pos, B: int, device, limit=None) -> torch.Tensor:
    """Broadcast pos (int, 0-d or [B] tensor) to a [B] int64 index; clamp
    into [0, limit-1] when given (the clamp of the JAX inplace.py::_as_vec)."""
    pos = torch.as_tensor(pos, device=device).reshape(-1).long().expand(B)
    if limit is not None:
        pos = pos.clamp(0, limit - 1)
    return pos


def device_positions(pos, B: int, device):
    """A position argument as the kernels read it: (int32 tensor on the
    device, stride) where stride 0 broadcasts one value to every row."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if pos.numel() == 1:
        return pos, 0
    if pos.numel() != B:
        raise ValueError(f"positions must be a scalar or [B={B}], got {tuple(pos.shape)}")
    return pos.contiguous(), 1


def _check_bf16_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                f"{name}: CUDA kernel takes contiguous bfloat16 tensors on one device, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


# ---------------------------------------------------------------------------
# write_row: buf[b, :, pos[b], :] = row, pos clamped into [0, T-1]; K and V in one launch
# ---------------------------------------------------------------------------


def write_row_plain(buf: torch.Tensor, row: torch.Tensor, pos, v_buf=None, v_row=None) -> torch.Tensor:
    """Plain version of write_row (the same clamp, the same result)."""
    if buf.is_cuda:
        write_row_plain.cuda_calls += 1
    B, H, T, D = buf.shape
    p = position_vector(pos, B, buf.device, limit=T)
    bi = torch.arange(B, device=buf.device)
    for dst, src in ((buf, row),) if v_buf is None else ((buf, row), (v_buf, v_row)):
        dst[bi, :, p] = src[:, :, 0].to(dst.dtype)
    return buf


write_row_plain.cuda_calls = 0


def write_row(buf: torch.Tensor, row: torch.Tensor, pos, v_buf=None, v_row=None) -> torch.Tensor:
    """buf [B, H, T, D]; row [B, H, 1, D]; pos int, 0-d or [B] tensor.

    Writes row at (b, :, pos[b], :) IN PLACE and returns buf. pos is
    clamped into [0, T-1] so an overrun never leaves the buffer. With
    ``v_buf`` and ``v_row`` (of buf's and row's shapes) it writes v_row into
    v_buf at the same positions in the same launch: the decode step's K and V
    rows of a layer's full heads. The rows need not be contiguous: the kernel
    reads each (b, h) row by its strides (the channels contiguous, both rows
    with the same strides), as a ``transpose`` view of the projection's
    ``[B, 1, Hkv, D]`` output gives them.
    """
    if not buf.is_cuda:
        return write_row_plain(buf, row, pos, v_buf, v_row)
    B, H, T, D = buf.shape
    pair = v_buf is not None
    bufs, rows = (buf, v_buf) if pair else (buf,), (row, v_row) if pair else (row,)
    _check_bf16_cuda("write_row", *bufs)
    for r in rows:
        if (r.device != buf.device or r.dtype != torch.bfloat16 or tuple(r.shape) != (B, H, 1, D)
                or r.stride() != row.stride() or r.stride(3) != 1 or r.stride(0) % 8 or r.stride(1) % 8
                or r.data_ptr() % 16):
            raise ValueError(f"write_row: row {tuple(r.shape)} {r.dtype} with strides {r.stride()} for "
                             f"buffer {tuple(buf.shape)}: the kernel takes bfloat16 [B, H, 1, D] rows with "
                             "contiguous channels, 16-byte aligned, K and V alike")
    if (pair and tuple(v_buf.shape) != (B, H, T, D)) or D % 8 != 0:
        raise ValueError(f"write_row: buffers {tuple(buf.shape)} {tuple(v_buf.shape) if pair else ''}")
    p, stride = device_positions(pos, B, buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    lib = _lib()
    err = lib.write_row(buf.data_ptr(), v_buf.data_ptr() if pair else None, row.data_ptr(),
                        v_row.data_ptr() if pair else None, row.stride(0), row.stride(1),
                        p.data_ptr(), stride, B, H, T, D, stream)
    _build.check(lib, err, "write_row")
    write_row.launches += 1
    return buf


write_row.launches = 0


# ---------------------------------------------------------------------------
# write_streaming_rows: sink slot min(start, sink), ring slot start mod R
# ---------------------------------------------------------------------------


def write_streaming_rows_plain(k_sink, v_sink, k_ring, v_ring, k_row, v_row,
                               start, sink_size: int):
    """Plain version of write_streaming_rows (no clamp, as in the TPU kernel)."""
    if k_sink.is_cuda:
        write_streaming_rows_plain.cuda_calls += 1
    B = k_sink.shape[0]
    R = k_ring.shape[2]
    t = position_vector(start, B, k_sink.device)
    bi = torch.arange(B, device=k_sink.device)
    sink_slot = torch.minimum(t, torch.full_like(t, sink_size))
    ring_slot = torch.remainder(t, R)
    k, v = k_row[:, :, 0], v_row[:, :, 0]
    k_sink[bi, :, sink_slot] = k.to(k_sink.dtype)
    v_sink[bi, :, sink_slot] = v.to(v_sink.dtype)
    k_ring[bi, :, ring_slot] = k.to(k_ring.dtype)
    v_ring[bi, :, ring_slot] = v.to(v_ring.dtype)
    return k_sink, v_sink, k_ring, v_ring


write_streaming_rows_plain.cuda_calls = 0


def write_streaming_rows(k_sink, v_sink, k_ring, v_ring, k_row, v_row,
                         start, sink_size: int):
    """Decode-step streaming write, IN PLACE. k/v_row [B, Hs, 1, D]; start
    int, 0-d or [B] tensor. Sink slot min(start, sink) (past the sink the row
    lands in the never-visible overflow pad), ring slot start mod R, for K
    and V, in one launch. The rows need not be contiguous: the kernel reads
    each (b, h) row by its strides (the channels contiguous, both rows with
    the same strides), as a ``transpose`` view of the projection's ``[B, 1,
    Hkv, D]`` output gives them. Returns the four buffers."""
    if not k_sink.is_cuda:
        return write_streaming_rows_plain(
            k_sink, v_sink, k_ring, v_ring, k_row, v_row, start, sink_size
        )
    B, H, Ts, D = k_sink.shape
    R = k_ring.shape[2]
    _check_bf16_cuda("write_streaming_rows", k_sink, v_sink, k_ring, v_ring)
    if (tuple(v_sink.shape) != (B, H, Ts, D) or tuple(k_ring.shape) != (B, H, R, D)
            or tuple(v_ring.shape) != (B, H, R, D) or D % 8 != 0 or not 0 <= sink_size < Ts):
        raise ValueError("write_streaming_rows: inconsistent buffer shapes")
    for r in (k_row, v_row):
        if (r.device != k_sink.device or r.dtype != torch.bfloat16 or tuple(r.shape) != (B, H, 1, D)
                or r.stride() != k_row.stride() or r.stride(3) != 1 or r.stride(0) % 8 or r.stride(1) % 8
                or r.data_ptr() % 16):
            raise ValueError(f"write_streaming_rows: row {tuple(r.shape)} {r.dtype} with strides {r.stride()} for "
                             f"buffers {tuple(k_sink.shape)}: the kernel takes bfloat16 [B, H, 1, D] rows with "
                             "contiguous channels, 16-byte aligned, K and V alike")
    p, stride = device_positions(start, B, k_sink.device)
    stream = torch.cuda.current_stream(k_sink.device).cuda_stream
    lib = _lib()
    err = lib.write_streaming_rows(
        k_sink.data_ptr(), v_sink.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(),
        k_row.data_ptr(), v_row.data_ptr(), k_row.stride(0), k_row.stride(1), p.data_ptr(), stride,
        B, H, Ts, R, D, sink_size, stream,
    )
    _build.check(lib, err, "write_streaming_rows")
    write_streaming_rows.launches += 1
    return k_sink, v_sink, k_ring, v_ring


write_streaming_rows.launches = 0


# ---------------------------------------------------------------------------
# write_q4_token: quantize one token to INT4 and merge it into its pair-row
# ---------------------------------------------------------------------------


def _q4_targets(bq, bs, row, v_bq, v_bs, v_row):
    """(packed, scales, row) of K, and of V when the pair form is asked for."""
    return [(bq, bs, row)] + ([] if v_bq is None else [(v_bq, v_bs, v_row)])


def write_q4_token_plain(bq: torch.Tensor, bs: torch.Tensor, row: torch.Tensor, start,
                         v_bq=None, v_bs=None, v_row=None):
    """Plain version of write_q4_token: ``quantize_int4_nibbles`` plus
    indexed writes (the same clamp, the same bytes and scales)."""
    if bq.is_cuda:
        write_q4_token_plain.cuda_calls += 1
    B, H, T2, D = bq.shape
    t = position_vector(start, B, bq.device, limit=2 * T2)
    par, r = t % 2, t // 2
    bi = torch.arange(B, device=bq.device)
    odd = (par == 1)[:, None, None]
    for q_buf, s_buf, src in _q4_targets(bq, bs, row, v_bq, v_bs, v_row):
        nib, scales = quantize_int4_nibbles(src)  # [B, H, 1, D] u8, [B, H, 2, 1] bf16
        old = q_buf[bi, :, r]  # [B, H, D]
        q_buf[bi, :, r] = torch.where(odd, (old & 0x0F) | (nib[:, :, 0] << 4), (old & 0xF0) | nib[:, :, 0])
        s_buf[bi, :, par, r] = scales[:, :, 0, 0].to(s_buf.dtype)
        s_buf[bi, :, 2 + par, r] = scales[:, :, 1, 0].to(s_buf.dtype)
    return bq, bs


write_q4_token_plain.cuda_calls = 0


def write_q4_token(bq: torch.Tensor, bs: torch.Tensor, row: torch.Tensor, start,
                   v_bq=None, v_bs=None, v_row=None):
    """Quantize one token's row to INT4 and write it, IN PLACE.

    bq [B, H, T2, D] uint8, byte (r, d) = q4(token 2r, d) | q4(token 2r+1, d)
    << 4; bs [B, H, 4, T2] bfloat16, rows (scale_even, scale_odd, zp_even,
    zp_odd); row [B, H, 1, D] (bfloat16 for the kernel); start int, 0-d or
    [B] tensor, clamped into [0, 2*T2 - 1]. Token t lands in pair-row t // 2,
    in the low nibble when t is even and the high nibble when odd; its
    partner's nibble and every other byte are kept. Unlike the JAX function,
    which takes nibbles its caller quantized, this one quantizes too (one
    kernel on the card). With ``v_bq``, ``v_bs`` and ``v_row`` (of bq's, bs's
    and row's shapes) it writes v_row into them at the same positions in the
    same launch: the decode step's K and V rows of a layer's full heads. The
    rows need not be contiguous: the kernel reads each (b, h) row by its
    strides (the channels contiguous, both rows with the same strides), as a
    ``transpose`` view of the projection's ``[B, 1, Hkv, D]`` output gives
    them. Returns (bq, bs)."""
    if not bq.is_cuda:
        return write_q4_token_plain(bq, bs, row, start, v_bq, v_bs, v_row)
    B, H, T2, D = bq.shape
    pair = v_bq is not None
    for q_buf, s_buf, r in _q4_targets(bq, bs, row, v_bq, v_bs, v_row):
        _check_bf16_cuda("write_q4_token", s_buf)
        if (q_buf.device != bq.device or s_buf.device != bq.device or q_buf.dtype != torch.uint8
                or not q_buf.is_contiguous() or tuple(q_buf.shape) != (B, H, T2, D)
                or tuple(s_buf.shape) != (B, H, 4, T2) or D % 128 != 0):
            raise ValueError(f"write_q4_token: packed {tuple(q_buf.shape)} {q_buf.dtype}, scales "
                             f"{tuple(s_buf.shape)}: the kernel needs contiguous uint8 [B,H,T2,D] and bf16 "
                             "[B,H,4,T2] with D a multiple of 128")
        # the kernel reads 4 channels (8 bytes) at a time
        if (r.device != bq.device or r.dtype != torch.bfloat16 or tuple(r.shape) != (B, H, 1, D)
                or r.stride() != row.stride() or r.stride(3) != 1 or r.stride(0) % 4 or r.stride(1) % 4
                or r.data_ptr() % 8):
            raise ValueError(f"write_q4_token: row {tuple(r.shape)} {r.dtype} with strides {r.stride()} for "
                             f"packed buffer {tuple(bq.shape)}: the kernel takes bfloat16 [B, H, 1, D] rows "
                             "with contiguous channels, 8-byte aligned, strides multiples of 4, K and V alike")
    p, stride = device_positions(start, B, bq.device)
    lib = _lib()
    err = lib.write_q4_token(bq.data_ptr(), bs.data_ptr(), row.data_ptr(),
                             v_bq.data_ptr() if pair else None, v_bs.data_ptr() if pair else None,
                             v_row.data_ptr() if pair else None, row.stride(0), row.stride(1),
                             p.data_ptr(), stride, B, H, T2, D, torch.cuda.current_stream(bq.device).cuda_stream)
    _build.check(lib, err, "write_q4_token")
    write_q4_token.launches += 1
    return bq, bs


write_q4_token.launches = 0
