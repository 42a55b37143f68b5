"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a GPU and nvcc; elsewhere they skip. On a machine with a card
(which need not have jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

chip_smoke.py holds the kernels to the plain versions at the main path's
shapes; these cover the shapes it does not reach: ragged query tiles, query
groups of 1 to 8, no sink, small rings that wrap, per-sequence lengths, the
decode's partition with one block a pair and many, the serving pool's shape
(rows with no query among long live ones, a graph replayed after the lengths
and the valid rows change, its only kernels), capture into a CUDA graph,
odd and even token parity in the INT4 cache, a poisoned cache past the INT4
frontier, the INT4 decode at query groups of 1 to 8 with most of its splits
empty and replayed from a graph, the streaming decode before the sink is
full, across the ring's wrap, with no sink, a tiny window and a wide one, and
replayed from a graph, the K/V pair writes (bf16 and INT4) and the streaming
write from strided rows, every route and tile boundary of the int8 matrix
product and its model shapes at M = 17 and 4096, the fused small-M linear
(quantization inside the kernel) at M = 1 to 16 for groups of one to three
weights, ragged widths, K = 14,336 and row-strided inputs, fewer blocks
than tiles, x staged whole and in K-chunks, every decode group of
Mistral-7B at the pool's row counts from bf16, float32 and int8 x, as one
launch that a CUDA graph replays, the engine's captured decode step against the
eager loop in both formats (greedy and sampled), the serving pool's
captured steps against its eager step and a freed slot past the bucket in
both formats, sampling under capture, the serving pool's shapes (the
streaming decode and the streaming write on its decode-only buffers at B = 4
and 8, the INT4 decode and pair write at B = 8 with ragged lengths near
32,500), and the wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch import DuoConfig, DuoEngine, ModelConfig
from duo_attention_tpu_torch.models import llama
from duo_attention_tpu_torch.ops import flash, gemm, inplace, launches, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# Queries are drawn this many times larger than the keys, so the scores are
# peaked and a masking or tiling fault changes the output.
Q_PEAK = 4.0


def randn(gen, *shape, mul=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * mul).to(torch.bfloat16)


def device_kernels(call):
    """Names of the device kernels one call of ``call`` runs, from
    torch.profiler. The profiler can lose the device records of the first
    launches after it starts, so 10,000 tiny launches go first and only the
    events of a marked range after them count (as chip_smoke.py's
    _profiled_window does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10000):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        with record_function("device_kernels_window"):
            call()
            torch.cuda.synchronize()
    events = prof.events()
    # the range on the host (the profiler may also draw it on the device timeline)
    start = min(e.time_range.start for e in events if e.name == "device_kernels_window")
    return [e.name for e in events if e.device_type == DeviceType.CUDA and e.time_range.start >= start
            and e.name != "device_kernels_window"]


def assert_bf16_close(got, want):
    """Within flash.kernel_tolerance, the bound chip_smoke.py holds them to."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash.kernel_tolerance(want)).all()), f"max err {float(err.max())}"


@pytest.mark.parametrize("B,S,Hq,Hkv,T,cs,bucket", [
    (2, 100, 8, 8, 1024, [0, 500], 1024),  # ragged query tile, G = 1
    (1, 64, 4, 1, 256, 192, 0),  # chunk ends at the buffer's end
    (1, 1, 16, 2, 512, 300, 512),  # decode, G = 8
    (3, 1, 8, 4, 768, [0, 766, 5], 768),  # decode, per-sequence lengths
    (2, 130, 4, 2, 4096, [1000, 3000], 4096),
    (1, 1000, 8, 2, 2048, 517, 2048),  # S not a multiple of the 128-row query tile, odd start
    (1, 65, 4, 4, 512, 0, 512),  # the second warpgroup of the tile holds one row; G = 1
    (4, 256, 16, 2, 2048, [0, 100, 1024, 1792], 2048),  # B = 4, G = 8
    (1, 192, 4, 1, 1024, 832, 0),  # bucket 0: the whole buffer; the chunk ends at its end
    (1, 1, 4, 4, 512, 511, 512),  # decode, G = 1, a block a tile, the last slot
    (1, 1, 16, 4, 32768, 32767, 32768),  # decode, G = 4, every tile full
    (1, 1, 16, 4, 16384, 16001, 16384),  # decode, an odd tail: the last tile holds two keys
    (3, 1, 16, 2, 8192, [5, 4096, 8191], 8192),  # decode, G = 8, B = 3, mixed lengths: shares cross rows
    (2, 1, 8, 2, 4096, [700, 4095], 0),  # decode, bucket 0: the plan comes from the buffer
    (1, 1, 12, 4, 1536, 0, 1536),  # decode, G = 3, one key in all: one block of the grid has work
])
def test_full_cache_attention_kernel(dev, B, S, Hq, Hkv, T, cs, bucket):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = randn(gen, B, S, Hq, 128, mul=Q_PEAK)
    k, v = randn(gen, B, Hkv, T, 128), randn(gen, B, Hkv, T, 128)
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.full_cache_attention(q, k, v, cs, bucket=bucket)
    want = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket)
    torch.cuda.synchronize()
    assert_bf16_close(got, want)


@pytest.mark.parametrize("B,S,Hq,Hs,sink,recent,chunk,R,cs", [
    (1, 37, 4, 2, 4, 8, 64, 128, 0),
    (2, 64, 8, 4, 4, 8, 64, 128, [64, 300]),  # wrapped ring
    (1, 130, 2, 2, 0, 16, 130, 512, 1000),  # no sink, ragged tile, G = 1
    (2, 1, 16, 2, 64, 256, 4096, 4608, [3, 9000]),  # decode, G = 8
    (3, 1, 4, 1, 16, 32, 64, 128, [0, 17, 500]),
    (1, 256, 8, 2, 64, 256, 256, 512, 1900),  # tokens 1900..2155 cross the wrap at 2048 = 4 * R
    (2, 200, 4, 4, 64, 256, 256, 512, [900, 1500]),  # ragged tile, G = 1, one walk wraps
    (1, 100, 8, 2, 64, 256, 128, 512, 10),  # cs < sink: the chunk fills the sink as it goes
    (2, 65, 16, 2, 4, 8, 128, 256, [0, 1000]),  # G = 8, a one-row warpgroup, tiny window
    (1, 1, 4, 4, 64, 256, 4096, 4608, 40),  # decode before the sink is full, G = 1
    (1, 1, 16, 4, 64, 256, 4096, 4608, 10),  # decode, cs < sink, G = 4
    (1, 1, 16, 4, 64, 256, 4096, 4608, 4700),  # decode, tokens 4444..4700 cross slot R = 4608
    (4, 1, 16, 4, 64, 256, 4096, 4608, [5, 64, 4700, 32000]),  # decode, B = 4, mixed lengths: empty splits
    (1, 1, 16, 2, 64, 256, 4096, 4608, 16000),  # decode, G = 8
    (2, 1, 8, 2, 0, 256, 4096, 4608, [300, 16000]),  # decode, no sink
    (2, 1, 8, 4, 64, 8, 4096, 4608, [100, 16000]),  # decode, a tiny window (recent 8)
    (1, 1, 4, 1, 128, 2048, 4096, 4608, 16000),  # decode, a window past one tile a warp
])
def test_streaming_cache_attention_kernel(dev, B, S, Hq, Hs, sink, recent, chunk, R, cs):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = randn(gen, B, S, Hq, 128, mul=Q_PEAK)
    bufs = [randn(gen, B, Hs, sink + chunk, 128), randn(gen, B, Hs, sink + chunk, 128),
            randn(gen, B, Hs, R, 128), randn(gen, B, Hs, R, 128)]
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.streaming_cache_attention(q, *bufs, cs, cs + S, sink, recent)
    want = flash.streaming_cache_attention_plain(q, *bufs, cs, cs + S, sink, recent)
    torch.cuda.synchronize()
    assert_bf16_close(got, want)


@pytest.mark.parametrize("S", [1, 192])
def test_attention_kernels_capture_into_a_cuda_graph(dev, S):
    """Launching reads nothing back from the device (lengths stay there; the
    decode's grid comes from the bucket): both wrappers are captured on a
    side stream, twice each, and the replay gives the eager result."""
    gen = torch.Generator(device=dev).manual_seed(8)
    B, Hq, Hkv, T, sink, recent, R = 2, 8, 2, 4096, 64, 256, 512
    q = randn(gen, B, S, Hq, 128, mul=Q_PEAK)
    k, v = randn(gen, B, Hkv, T, 128), randn(gen, B, Hkv, T, 128)
    bufs = [randn(gen, B, Hkv, sink + 256, 128), randn(gen, B, Hkv, sink + 256, 128),
            randn(gen, B, Hkv, R, 128), randn(gen, B, Hkv, R, 128)]
    cs = torch.tensor([3000, 3800], dtype=torch.int32, device=dev)
    tot = cs + S
    want = (flash.full_cache_attention(q, k, v, cs, bucket=T),
            flash.streaming_cache_attention(q, *bufs, cs, tot, sink, recent))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # captures on a side stream
        for _ in range(2):
            got = (flash.full_cache_attention(q, k, v, cs, bucket=T),
                   flash.streaming_cache_attention(q, *bufs, cs, tot, sink, recent))
    for g in got:
        g.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_bf16_close(got[0], flash.full_cache_attention_plain(q, k, v, cs, bucket=T))


def _pool_rows(gen, hf, B=16, live=5, T=32768):
    """The serving pool's full-head decode at longdoc's shape: B rows, ``live``
    of them at 4k-28k keys, the rest freed at stale lengths (some past the
    bucket) with valid 0; query groups of 4, bucket 32,768."""
    q = randn(gen, B, 1, 4 * hf, 128, mul=Q_PEAK)
    k, v = randn(gen, B, hf, T, 128), randn(gen, B, hf, T, 128)
    rows = torch.randperm(B, generator=torch.Generator().manual_seed(hf))
    valid = torch.zeros(B, dtype=torch.int32)
    valid[rows[:live]] = 1
    cs = torch.where(valid > 0, torch.randint(4096, 28672, (B,), generator=torch.Generator().manual_seed(hf)),
                     torch.randint(0, 2 * T, (B,), generator=torch.Generator().manual_seed(hf + 1)))
    return q, k, v, cs.to(torch.int32).to(q.device), valid.to(q.device)


def _check_pool_rows(got, q, k, v, cs, valid, bucket):
    want = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket, valid=valid)
    torch.cuda.synchronize()
    live = valid > 0
    assert_bf16_close(got[live], want[live])
    assert bool((got[~live] == 0).all()), "a row with no query must give 0"


@pytest.mark.parametrize("hf", [1, 8])
def test_full_cache_attention_decode_at_the_pool_shape(dev, hf):
    """16 rows, 5 live at 4k-28k and 11 freed at stale lengths, bucket
    32,768: the live rows within kernel_tolerance of the plain version, the
    freed ones exactly 0; the profiler sees the partitioned kernel and its
    merge and nothing else."""
    gen = torch.Generator(device=dev).manual_seed(60 + hf)
    q, k, v, cs, valid = _pool_rows(gen, hf)
    call = lambda: flash.full_cache_attention(q, k, v, cs, bucket=32768, valid=valid)  # noqa: E731
    got = call()
    _check_pool_rows(got, q, k, v, cs, valid, 32768)
    before = flash.full_cache_attention.decode_launches
    kernels = device_kernels(call)
    assert flash.full_cache_attention.decode_launches == before + 1
    assert len(kernels) == 2 and all("decode_kernel<" in n.replace(" ", "") or "decode_merge_kernel" in n
                                     for n in kernels), kernels


def test_full_cache_attention_decode_graph_replays_as_lengths_change(dev):
    """A decode captured once replays right after the lengths and the valid
    rows change in place (the partition is made on the device), and each
    replay equals the eager call bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(70)
    q, k, v, cs, valid = _pool_rows(gen, 4)
    cs_buf, valid_buf = cs.clone(), valid.clone()
    call = lambda: flash.full_cache_attention(q, k, v, cs_buf, bucket=32768, valid=valid_buf)  # noqa: E731
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for step in range(3):
        if step:  # rows freed and admitted, every length moved
            cs_buf.copy_(torch.roll(cs_buf, 3) + 17 * step)
            valid_buf.copy_(torch.roll(valid_buf, 5))
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, call())
        _check_pool_rows(got, q, k, v, cs_buf, valid_buf, 32768)


def test_streaming_decode_is_one_launch_and_replays(dev):
    """One kernel a call (the profiler sees stream_decode_kernel and nothing
    else); one captured call, replayed three times, equals the eager call bit
    for bit each time."""
    gen = torch.Generator(device=dev).manual_seed(16)
    B, Hq, Hs, sink, recent, R = 2, 16, 4, 64, 256, 4608
    q = randn(gen, B, 1, Hq, 128, mul=Q_PEAK)
    bufs = [randn(gen, B, Hs, sink + 4096, 128), randn(gen, B, Hs, sink + 4096, 128),
            randn(gen, B, Hs, R, 128), randn(gen, B, Hs, R, 128)]
    cs = torch.tensor([16000, 4700], dtype=torch.int32, device=dev)
    tot = cs + 1
    call = lambda: flash.streaming_cache_attention(q, *bufs, cs, tot, sink, recent)  # noqa: E731
    want = call()
    torch.cuda.synchronize()
    before = flash.streaming_cache_attention.decode_launches
    kernels = device_kernels(call)
    assert flash.streaming_cache_attention.decode_launches == before + 1
    assert len(kernels) == 1 and "stream_decode_kernel" in kernels[0], kernels
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert_bf16_close(got, flash.streaming_cache_attention_plain(q, *bufs, cs, tot, sink, recent))


@pytest.mark.parametrize("pos", [0, 511, 600, [3, 0, 511], [-4, 1000, 17]])
def test_write_row_kernel(dev, pos):
    gen = torch.Generator(device=dev).manual_seed(2)
    buf, row = randn(gen, 3, 2, 512, 128), randn(gen, 3, 2, 1, 128)
    ref = buf.clone()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    inplace.write_row(buf, row, pos)
    inplace.write_row_plain(ref, row, pos)
    assert torch.equal(buf, ref)


@pytest.mark.parametrize("pos", [0, 511, 600, [3, 0, 511], [-4, 1000, 17]])
def test_write_row_pair_kernel_reads_strided_rows(dev, pos):
    """The decode step's write: K and V rows of the first 2 of 4 heads, read
    in place as ``transpose`` views of [B, 1, Hkv, D] projections, in one
    launch; bitwise equal to the plain version."""
    gen = torch.Generator(device=dev).manual_seed(12)
    kbuf, vbuf = randn(gen, 3, 2, 512, 128), randn(gen, 3, 2, 512, 128)
    kproj, vproj = randn(gen, 3, 1, 4, 128), randn(gen, 3, 1, 4, 128)
    krow, vrow = kproj[:, :, :2].transpose(1, 2), vproj[:, :, :2].transpose(1, 2)
    assert not krow.is_contiguous()
    refs = kbuf.clone(), vbuf.clone()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    before = inplace.write_row.launches
    inplace.write_row(kbuf, krow, pos, vbuf, vrow)
    assert inplace.write_row.launches == before + 1
    inplace.write_row_plain(refs[0], krow, pos, refs[1], vrow)
    torch.cuda.synchronize()
    assert torch.equal(kbuf, refs[0]) and torch.equal(vbuf, refs[1])


@pytest.mark.parametrize("start", [0, 70, [1, 64, 65], [127, 128, 4000]])
def test_write_streaming_rows_kernel(dev, start):
    gen = torch.Generator(device=dev).manual_seed(3)
    bufs = [randn(gen, 3, 2, 64 + 16, 128), randn(gen, 3, 2, 64 + 16, 128),
            randn(gen, 3, 2, 128, 128), randn(gen, 3, 2, 128, 128)]
    refs = [b.clone() for b in bufs]
    k_row, v_row = randn(gen, 3, 2, 1, 128), randn(gen, 3, 2, 1, 128)
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    inplace.write_streaming_rows(*bufs, k_row, v_row, start, 64)
    inplace.write_streaming_rows_plain(*refs, k_row, v_row, start, 64)
    assert all(torch.equal(a, b) for a, b in zip(bufs, refs))


def assert_q4_close(got, want):
    """Within flash.kernel_tolerance_q4, the bound chip_smoke.py holds the INT4 kernels to."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= flash.kernel_tolerance_q4(want)).all()), f"max err {float(err.max())}"


@pytest.mark.parametrize("B,S,Hq,Hkv,T,cs,bucket", [
    (2, 100, 8, 8, 1024, [0, 500], 1024),  # ragged query tile, G = 1
    (1, 64, 4, 1, 256, 192, 0),  # chunk ends at the buffer's end
    (1, 70, 4, 2, 512, 101, 512),  # odd start: the last key shares a byte row with an unseen one
    (1, 1, 16, 2, 512, 300, 512),  # decode, G = 8, even position, one split
    (1, 1, 8, 4, 512, 301, 0),  # decode, G = 2, odd position
    (3, 1, 8, 4, 4096, [0, 4095, 1500], 4096),  # decode, per-sequence lengths, 8 splits, some empty
    (2, 1, 4, 4, 32768, [20000, 32767], 32768),  # decode, G = 1, 32 splits of 1024 keys
    (1, 1, 12, 4, 1536, 1400, 0),  # decode, G = 3, splits of 512 over 1536 keys
    (2, 130, 4, 2, 4096, [1000, 3000], 4096),
    (1, 200, 8, 2, 1024, 300, 1024),  # S not a multiple of the 128-row query tile
    (1, 300, 8, 4, 2048, 517, 2048),  # odd start, not a multiple of 128: the diagonal tile splits a pair
    (1, 256, 4, 4, 512, 0, 512),  # cs = 0, G = 1
    (2, 129, 8, 4, 1024, [0, 640], 1024),  # G = 2, one row in the last query tile
    (1, 384, 16, 2, 2048, 1001, 2048),  # G = 8, odd frontier
    (4, 256, 16, 4, 2048, [0, 301, 1024, 1700], 2048),  # B = 4, mixed lengths and parities
])
def test_full_cache_attention_q4_kernel(dev, B, S, Hq, Hkv, T, cs, bucket):
    gen = torch.Generator(device=dev).manual_seed(5)
    q = randn(gen, B, S, Hq, 128, mul=Q_PEAK)
    kq, ks = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    vq, vs = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    kq, ks, vq, vs = (t.contiguous() for t in (kq, ks, vq, vs))
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs, bucket=bucket)
    want = flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, cs, bucket=bucket)
    torch.cuda.synchronize()
    assert_q4_close(got, want)


@pytest.mark.parametrize("B,S,cs", [(1, 301, 500), (2, 256, [0, 777])])
def test_full_cache_attention_q4_prefill_never_reads_past_the_frontier(dev, B, S, cs):
    """Slots at or past cs + S hold NaN scales and 0xF nibbles (the cache past
    its length is uninitialised), inside the bucket; the odd frontier's byte
    row holds a visible key and a poisoned one. The kernel on the poisoned
    cache equals the plain version on a clean one."""
    gen = torch.Generator(device=dev).manual_seed(9)
    Hq, Hkv, T = 8, 2, 2048
    q = randn(gen, B, S, Hq, 128, mul=Q_PEAK)
    kq, ks = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    vq, vs = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    kq, ks, vq, vs = (t.contiguous() for t in (kq, ks, vq, vs))
    ends = torch.as_tensor(cs, device=dev).reshape(-1).expand(B) + S
    slot = torch.arange(T, device=dev)
    past = slot[None] >= ends[:, None]  # [B, T]
    clean = [t.clone() for t in (kq, ks, vq, vs)]
    for b in range(B):
        clean[0][b, :, past[b, 0::2]] = 0  # a clean cache: zeros past the frontier
        clean[2][b, :, past[b, 0::2]] = 0
        for packed in (kq, vq):
            packed[b, :, past[b, 0::2]] = 0xFF  # both nibbles of rows wholly past it
            packed[b, :, past[b, 1::2] & ~past[b, 0::2]] |= 0xF0  # the odd partner past an odd frontier
        for scales in (ks, vs):
            scales[b, :, 0::2][..., past[b, 0::2]] = float("nan")  # scale_even, zp_even rows
            scales[b, :, 1::2][..., past[b, 1::2]] = float("nan")
    cs_t = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs_t, bucket=T)
    want = flash.full_cache_attention_q4_plain(q, *clean, cs_t, bucket=T)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert_q4_close(got, want)


def _q4_cache(gen, B, Hkv, T):
    kq, ks = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    vq, vs = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 128))
    return [t.contiguous() for t in (kq, ks, vq, vs)]


@pytest.mark.parametrize("B,Hq,Hkv,T,cs,bucket", [
    (1, 4, 4, 32768, 16000, 16384),  # the main path's span, G = 1
    (1, 8, 4, 32768, 16000, 16384),  # G = 2
    (1, 12, 4, 16384, 9001, 16384),  # G = 3, odd frontier
    (1, 16, 4, 32768, 16001, 16384),  # G = 4 (the 8B model), odd frontier
    (1, 20, 4, 8192, 5000, 8192),  # G = 5
    (1, 24, 4, 8192, 8191, 8192),  # G = 6, the bucket's last key
    (1, 28, 4, 4096, 4000, 4096),  # G = 7
    (1, 32, 4, 4096, 2047, 4096),  # G = 8, half the splits empty
    (4, 16, 4, 16384, 16000, 16384),  # B = 4
    (4, 16, 2, 16384, [5, 4097, 12345, 16383], 16384),  # B = 4, [B] lengths, odd and even frontiers
    (1, 16, 4, 128, 57, 100),  # a span below one tile
    (2, 8, 2, 256, [99, 36], 100),  # a span below one tile, [B] lengths
    (1, 16, 4, 32768, 300, 32768),  # a sequence far shorter than the bucket: 31 of 32 splits empty
    (2, 24, 6, 32768, [32767, 0], 0),  # bucket 0 (the whole buffer); one key in b = 1
    (1, 20, 5, 16384, 16000, 16384),  # the main path's hf = 5: splits of two tiles
    # the serving bench's B = 8 pool: ragged lengths near 32,500 beside short rows
    (8, 16, 4, 32768, [32500, 32511, 32256, 32301, 5, 300, 16001, 32767], 32768),
])
def test_full_cache_attention_q4_decode_kernel(dev, B, Hq, Hkv, T, cs, bucket):
    gen = torch.Generator(device=dev).manual_seed(13)
    q = randn(gen, B, 1, Hq, 128, mul=Q_PEAK)
    cache = _q4_cache(gen, B, Hkv, T)
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    before = flash.full_cache_attention_q4.decode_launches
    got = flash.full_cache_attention_q4(q, *cache, cs, bucket=bucket)
    assert flash.full_cache_attention_q4.decode_launches == before + 1
    want = flash.full_cache_attention_q4_plain(q, *cache, cs, bucket=bucket)
    torch.cuda.synchronize()
    assert_q4_close(got, want)


@pytest.mark.parametrize("cs", [1500, 1501, [700, 2047]])
def test_full_cache_attention_q4_decode_never_reads_past_the_frontier(dev, cs):
    """Decode over a cache holding NaN scales and 0xF nibbles at every slot
    past the query (inside the bucket; an odd frontier's pair row holds the
    visible key and a poisoned one) equals the plain version on a clean one."""
    gen = torch.Generator(device=dev).manual_seed(14)
    cs_t = torch.as_tensor(cs, dtype=torch.int32, device=dev).reshape(-1)
    B, Hq, Hkv, T = cs_t.numel(), 16, 4, 2048
    q = randn(gen, B, 1, Hq, 128, mul=Q_PEAK)
    kq, ks, vq, vs = _q4_cache(gen, B, Hkv, T)
    past = torch.arange(T, device=dev)[None] > cs_t[:, None]  # [B, T]
    clean = [t.clone() for t in (kq, ks, vq, vs)]
    for b in range(B):
        for packed, kept in ((kq, clean[0]), (vq, clean[2])):
            kept[b, :, past[b, 0::2]] = 0
            packed[b, :, past[b, 0::2]] = 0xFF
            packed[b, :, past[b, 1::2] & ~past[b, 0::2]] |= 0xF0
        for scales in (ks, vs):
            scales[b, :, 0::2][..., past[b, 0::2]] = float("nan")
            scales[b, :, 1::2][..., past[b, 1::2]] = float("nan")
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs_t, bucket=T)
    want = flash.full_cache_attention_q4_plain(q, *clean, cs_t, bucket=T)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert_q4_close(got, want)


def test_full_cache_attention_q4_decode_is_one_launch_and_replays(dev):
    """One kernel a call (the profiler sees decode_q4_kernel and nothing else);
    one captured call, replayed three times, equals the eager call bit for bit
    each time: the kernel puts its ticket counters back to 0, so the graph
    needs no memset."""
    gen = torch.Generator(device=dev).manual_seed(15)
    B, Hq, Hkv, T = 2, 16, 4, 16384
    q = randn(gen, B, 1, Hq, 128, mul=Q_PEAK)
    cache = _q4_cache(gen, B, Hkv, T)
    cs = torch.tensor([16000, 9001], dtype=torch.int32, device=dev)
    want = flash.full_cache_attention_q4(q, *cache, cs, bucket=T)
    torch.cuda.synchronize()
    kernels = device_kernels(lambda: flash.full_cache_attention_q4(q, *cache, cs, bucket=T))
    assert len(kernels) == 1 and "decode_q4_kernel" in kernels[0], kernels
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash.full_cache_attention_q4(q, *cache, cs, bucket=T)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    tickets = [buf for key, buf in flash._decode_scratch.items() if key[0] == "q4_tickets"]
    assert tickets and all(int(buf.abs().sum()) == 0 for buf in tickets)


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_engine_decode_graph_equals_the_eager_loop(dev, kv_quant):
    """DuoEngine on the card replays a captured decode step (bursts of 8, 8
    and 4: an eager warm-up step, then replays): its greedy tokens, cache
    length and launch counts equal a loop of eager forward_chunk steps at the
    same bucket, in both formats, at reduced depth and width."""
    cfg = ModelConfig(vocab_size=2048, hidden_size=1024, intermediate_size=2048, num_layers=3,
                      num_heads=16, num_kv_heads=4, head_dim=128, rope_theta=500000.0)
    duo = DuoConfig(sink_size=64, recent_size=256, num_full_kv_heads=(2, 4, 1),
                    max_cache_size=4096, prefill_chunk_size=512)
    if kv_quant == "int4":
        params = quant.init_params_w8a8_random(cfg, seed=0, device="cuda", quantize_embeds=True)
    else:
        params = llama.init_params(cfg, seed=0, device="cuda")
    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant, decode_burst=8)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1100))
    steps = 20

    cache, logits = engine.prefill(ids)
    before = launches.snapshot()
    tokens, cache = engine.decode_tokens(cache, torch.argmax(logits, -1), steps, length=1100)
    graph_counts = [a - b for a, b in zip(launches.snapshot(), before)]

    eager_cache, logits = engine.prefill(ids)
    token = torch.argmax(logits, -1)
    bucket = engine.bucket_for(1100 + steps)
    eager = []
    before = launches.snapshot()
    with torch.no_grad():
        for _ in range(steps):
            eager.append(int(token[0]))
            hidden, eager_cache = llama.forward_chunk(params, cfg, duo, eager_cache, token[:, None], 1,
                                                      full_bucket=bucket)
            token = torch.argmax(llama.logits_at(params, hidden, 0), dim=-1)
    eager_counts = [a - b for a, b in zip(launches.snapshot(), before)]
    assert tokens[0].tolist() == eager
    assert int(cache.length) == int(eager_cache.length) == 1100 + steps
    assert graph_counts == eager_counts and sum(graph_counts) > 0


@pytest.mark.parametrize("start", [0, 1, 510, 511, 1023, 1500, [3, 0, 1022], [-4, 2000, 17], [8, 9, 9]])
def test_write_q4_token_kernel(dev, start):
    """Bitwise: bytes (the partner nibble and every other byte kept) and bf16 scales."""
    gen = torch.Generator(device=dev).manual_seed(6)
    B, H, T2, D = 3, 2, 512, 128
    bq = torch.randint(0, 256, (B, H, T2, D), generator=gen, device=dev, dtype=torch.uint8)
    bs = randn(gen, B, H, 4, T2)
    row = randn(gen, B, H, 1, D, mul=3.0)
    row[0, 0] = 1.25  # a constant row: scale is the 1e-8 floor
    ref_q, ref_s = bq.clone(), bs.clone()
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    inplace.write_q4_token(bq, bs, row, start)
    inplace.write_q4_token_plain(ref_q, ref_s, row, start)
    assert torch.equal(bq, ref_q)
    assert torch.equal(bs.view(torch.int16), ref_s.view(torch.int16))


@pytest.mark.parametrize("B,H,T2,start", [
    *((3, 2, 512, start) for start in [0, 1, 1022, 1023, 1500, [3, 0, 1022], [-4, 2000, 17], [8, 9, 9]]),
    # the serving bench's B = 8 pool (max_cache_size 32768): ragged positions near 32,500 beside short rows
    (8, 4, 16384, [32500, 32511, 32256, 32301, 5, 300, 16001, 32767]),
])
def test_write_q4_token_pair_kernel_reads_strided_rows(dev, B, H, T2, start):
    """The decode step's INT4 write: K and V rows of the first H of 2H heads,
    read in place as ``transpose`` views of [B, 1, Hkv, D] projections, in
    one launch; bitwise equal to the plain version (bytes and bf16 scales)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    D = 128
    bufs = [torch.randint(0, 256, (B, H, T2, D), generator=gen, device=dev, dtype=torch.uint8),
            randn(gen, B, H, 4, T2)]
    bufs += [torch.randint(0, 256, (B, H, T2, D), generator=gen, device=dev, dtype=torch.uint8),
             randn(gen, B, H, 4, T2)]
    kproj, vproj = randn(gen, B, 1, 2 * H, D, mul=3.0), randn(gen, B, 1, 2 * H, D, mul=3.0)
    kproj[0, 0, 1] = 1.25  # a constant row: scale is the 1e-8 floor
    krow, vrow = kproj[:, :, :H].transpose(1, 2), vproj[:, :, :H].transpose(1, 2)
    assert not krow.is_contiguous()
    refs = [b.clone() for b in bufs]
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    before = inplace.write_q4_token.launches
    inplace.write_q4_token(bufs[0], bufs[1], krow, start, bufs[2], bufs[3], vrow)
    assert inplace.write_q4_token.launches == before + 1
    inplace.write_q4_token_plain(refs[0], refs[1], krow, start, refs[2], refs[3], vrow)
    torch.cuda.synchronize()
    assert torch.equal(bufs[0], refs[0]) and torch.equal(bufs[2], refs[2])
    assert torch.equal(bufs[1].view(torch.int16), refs[1].view(torch.int16))
    assert torch.equal(bufs[3].view(torch.int16), refs[3].view(torch.int16))


@pytest.mark.parametrize("route", ["tiled", "small"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [
    (1, 128, 64), (2, 130, 4096), (4, 1024, 14336), (8, 8, 16), (9, 257, 4096), (16, 256, 512),
    (17, 128, 64), (127, 129, 80), (128, 128, 192), (129, 255, 208), (300, 512, 4096), (256, 1000, 48),
    # ragged against the 128 x 256 tile and the 128-byte slab
    (300, 300, 144), (129, 257, 400), (255, 511, 272), (385, 768, 1040),
])
def test_w8a8_matmul_kernel(dev, route, out_dtype, M, N, K):
    """Bitwise against the plain version: both routes at every M, with tile
    edges in M, N and K (K a multiple of 16, not of the 64-byte slab)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
    xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
    ws = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-3
    got = gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype, route=route)
    want = gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, want)


# The 8B model's five weight shapes (N = out features, K = in features), as chip_smoke.py names them.
GEMM_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (1024, 4096), "gate/up": (14336, 4096),
               "down": (4096, 14336), "head": (128256, 4096)}


@pytest.mark.parametrize("M", [17, 4096])
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_w8a8_matmul_kernel_at_the_model_shapes(dev, shape, M):
    """The tiled route (M > SMALL_M_MAX) at every weight shape of the 8B
    model, bitwise; the head in float32, as the model runs it."""
    N, K = GEMM_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(10)
    out_dtype = torch.float32 if shape == "head" else torch.bfloat16
    xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
    xs = torch.rand((M, 1), generator=gen, device=dev) * 0.02 + 1e-3
    ws = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
    got = gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype)
    want = gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,N", [(300, 300), (4096, 256)])
def test_w8a8_matmul_saturated_signs_at_long_k(dev, M, N):
    """+-127 operands with random signs over K = 14336 (sums up to 2.3e8 in
    magnitude) stay exact on the tiled route."""
    K = 14336
    gen = torch.Generator(device=dev).manual_seed(11)
    sign = lambda *s: torch.randint(0, 2, s, generator=gen, device=dev, dtype=torch.int8) * 2 - 1  # noqa: E731
    xq, wq = sign(M, K) * 127, sign(N, K) * 127
    xq[0], wq[0] = 127, -127  # one output at the extreme
    xs, ws = torch.full((M, 1), 1e-3, device=dev), torch.full((N,), 1e-3, device=dev)
    got = gemm.w8a8_matmul(xq, xs, wq, ws, torch.float32)
    assert gemm.w8a8_matmul.tiled_launches > 0
    assert torch.equal(got, gemm.w8a8_matmul_plain(xq, xs, wq, ws, torch.float32))


def test_w8a8_matmul_saturated_operands_and_auto_route(dev):
    """Every product at its extreme (+-127 * +-127 over K = 14336) stays exact,
    and the wrapper picks the small route up to SMALL_M_MAX, the tiled one past it."""
    K, N = 14336, 256
    wq = torch.full((N, K), -127, dtype=torch.int8, device=dev)
    ws = torch.full((N,), 1e-3, device=dev)
    for M in (gemm.SMALL_M_MAX, gemm.SMALL_M_MAX + 1):
        xq = torch.full((M, K), 127, dtype=torch.int8, device=dev)
        xs = torch.full((M, 1), 1e-3, device=dev)
        before = (gemm.w8a8_matmul.small_launches, gemm.w8a8_matmul.tiled_launches)
        got = gemm.w8a8_matmul(xq, xs, wq, ws, torch.float32)
        after = (gemm.w8a8_matmul.small_launches, gemm.w8a8_matmul.tiled_launches)
        assert torch.equal(got, gemm.w8a8_matmul_plain(xq, xs, wq, ws, torch.float32))
        assert (after[0] - before[0], after[1] - before[1]) == ((1, 0) if M <= gemm.SMALL_M_MAX else (0, 1))


# (output widths of the group, K, x dtype, output dtype, x row-strided)
SMALL_GROUPS = [
    ((4096, 1024, 1024), 4096, torch.bfloat16, torch.bfloat16, False),  # wq, wk, wv
    ((300, 17), 14336, torch.bfloat16, torch.float32, True),  # ragged widths, the down projection's K
    ((128,), 1040, torch.float32, torch.float32, True),  # K % 32 == 16: a half k-step of zeros
    ((1000, 24, 8), 48, torch.float32, torch.bfloat16, False),
]


def _small_group_inputs(gen, M, ns, K, x_dtype, strided):
    base = torch.randn((M, K + 64), generator=gen, device=gen.device) * 3
    x = base[:, 32 : 32 + K]  # row-strided: 64 elements past a row of K, 16-byte aligned
    if M > 1:
        x[0] = 0.0  # scale 1e-12
        x[1, :8] = torch.tensor([126.5, -126.5, 0.5, -1.5, 2.5, 127.0, -3.5, 1.0], device=gen.device)
        x[1, 8:] = x[1, 8:].clamp(-127, 127)  # absmax 127: scale 1, quotients on .5 ties
    x = base.to(x_dtype)[:, 32 : 32 + K] if strided else torch.empty((M, K), dtype=x_dtype, device=gen.device).copy_(x)
    weights = [(torch.randint(-127, 128, (n, K), generator=gen, device=gen.device, dtype=torch.int8),
                torch.rand((n,), generator=gen, device=gen.device) * 1e-3 + 1e-4) for n in ns]
    return x, weights


@pytest.mark.parametrize("group", range(len(SMALL_GROUPS)))
@pytest.mark.parametrize("M", range(1, 17))
def test_w8a8_small_group_kernel_is_bitwise_the_plain_group(dev, M, group):
    """The fused small-M route (x quantized per row inside the kernel, every
    weight of the group in one launch) against the plain group (plain-torch
    quantization once, then w8a8_matmul_plain each), bitwise, at M = 1 to 16:
    one 8-row operand a k-step up to 8 rows, two past it."""
    ns, K, x_dtype, out_dtype, strided = SMALL_GROUPS[group]
    gen = torch.Generator(device=dev).manual_seed(20 + M)
    x, weights = _small_group_inputs(gen, M, ns, K, x_dtype, strided)
    assert x.stride(0) == (K + 64 if strided else K)
    before = gemm.w8a8_matmul.small_launches
    got = quant.w8a8_linear_group(x, weights, out_dtype)
    assert gemm.w8a8_matmul.small_launches == before + 1
    want = quant.w8a8_linear_group(x, weights, out_dtype, plain=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == out_dtype and torch.equal(g, w)


@pytest.mark.parametrize("M", [1, 4, 8, 16])
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_w8a8_small_route_at_the_model_shapes(dev, shape, M):
    """Both modes of the small-M kernel at every weight shape of the 8B model,
    bitwise: the fused linear from bf16 x (the head in float32, as the model
    runs it), and the int8-input mode against w8a8_matmul_plain."""
    N, K = GEMM_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(30 + M)
    out_dtype = torch.float32 if shape == "head" else torch.bfloat16
    x, weights = _small_group_inputs(gen, M, (N,), K, torch.bfloat16, False)
    (got,) = quant.w8a8_linear_group(x, weights, out_dtype)
    (want,) = quant.w8a8_linear_group(x, weights, out_dtype, plain=True)
    assert torch.equal(got, want)
    xq, xs = quant.quantize_act_per_token(x)
    got = gemm.w8a8_matmul(xq, xs, *weights[0], out_dtype, route="small")
    torch.cuda.synchronize()
    assert torch.equal(got, gemm.w8a8_matmul_plain(xq, xs, *weights[0], out_dtype))


@pytest.mark.parametrize("blocks", [7, 16])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("M", [1, 8, 16])
def test_w8a8_small_route_with_fewer_blocks_than_tiles(dev, monkeypatch, M, group, blocks):
    """The kernel's persistent walk when the blocks split the group's tiles
    unevenly (as on a card of 7 or 16 SMs; 21 and 66 tiles here): every column
    of every matrix is still computed once, bitwise the plain group."""
    ns, K, x_dtype, out_dtype, strided = SMALL_GROUPS[group]
    monkeypatch.setitem(gemm._sm_counts, torch.cuda.current_device(), blocks)
    gen = torch.Generator(device=dev).manual_seed(60 + M)
    x, weights = _small_group_inputs(gen, M, ns, K, x_dtype, strided)
    got = quant.w8a8_linear_group(x, weights, out_dtype)
    want = quant.w8a8_linear_group(x, weights, out_dtype, plain=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_w8a8_small_route_sizes_its_ring_beside_x(dev, monkeypatch):
    """x comes whole where that leaves the ring four stages, else in
    K-chunks: at K = 23,808 and 23,824 (at most two stages beside 8 whole
    rows, none beside 16) both row counts are bitwise the plain version. A
    launch whose blocks cannot keep their tiles' sums across the chunks (one
    block over the 256 tiles of a down projection at 16 rows) is refused."""
    gen = torch.Generator(device=dev).manual_seed(70)
    for M in (8, 16):
        for K in (23808, 23824):
            x, weights = _small_group_inputs(gen, M, (40,), K, torch.bfloat16, False)
            (got,) = quant.w8a8_linear_group(x, weights)
            (want,) = quant.w8a8_linear_group(x, weights, plain=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (M, K)
    monkeypatch.setitem(gemm._sm_counts, torch.cuda.current_device(), 1)
    x, weights = _small_group_inputs(gen, 16, (4096,), 14336, torch.bfloat16, False)
    before = gemm.w8a8_matmul.small_launches
    with pytest.raises(RuntimeError):
        quant.w8a8_linear_group(x, weights)
    assert gemm.w8a8_matmul.small_launches == before


# Mistral-7B's decode groups: (output widths, K, output dtype), the head in float32 as the model runs it
MISTRAL_GROUPS = {"wq+wk+wv": ((4096, 1024, 1024), 4096, torch.bfloat16), "wo": ((4096,), 4096, torch.bfloat16),
                  "gate+up": ((14336, 14336), 4096, torch.bfloat16), "down": ((4096,), 14336, torch.bfloat16),
                  "head": ((32000,), 4096, torch.float32)}


@pytest.mark.parametrize("blocks", ["one an SM", 7])
@pytest.mark.parametrize("x_kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("M", [1, 8, 9, 12, 16])
@pytest.mark.parametrize("group", list(MISTRAL_GROUPS))
def test_w8a8_small_route_at_the_mistral_decode_groups(dev, monkeypatch, group, M, x_kind, blocks):
    """Every decode group of Mistral-7B on the small-M route at the serving
    pool's row counts, bitwise: from bf16 or float32 x the group in one launch
    against quantize_act_per_token and w8a8_matmul_plain each, from int8 x
    each weight through the int8-input mode. One block an SM (132 on an H100:
    the down projection at 9-16 rows walks 2 K-chunks) and 7 blocks, fewer
    than the tiles (there it walks 3, keeping 37 tiles' sums)."""
    ns, K, out_dtype = MISTRAL_GROUPS[group]
    if blocks != "one an SM":
        monkeypatch.setitem(gemm._sm_counts, torch.cuda.current_device(), blocks)
    gen = torch.Generator(device=dev).manual_seed(80 + M)
    x, weights = _small_group_inputs(gen, M, ns, K, torch.float32 if x_kind == "f32" else torch.bfloat16, False)
    xq, xs = quant.quantize_act_per_token(x)
    want = [gemm.w8a8_matmul_plain(xq, xs, wq, ws, out_dtype) for wq, ws in weights]
    counters = ("small_launches", "tiled_launches", "quantize_launches")
    before = [getattr(gemm.w8a8_matmul, c) for c in counters]
    if x_kind == "int8":
        got = [gemm.w8a8_matmul(xq, xs, wq, ws, out_dtype) for wq, ws in weights]
    else:
        got = quant.w8a8_linear_group(x, weights, out_dtype)
    launched = tuple(getattr(gemm.w8a8_matmul, c) - b for c, b in zip(counters, before))
    apart = x_kind != "int8" and M > gemm.QUANTIZE_IN_KERNEL_MAX
    assert launched == (len(weights) if x_kind == "int8" else 1, 0, int(apart))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == out_dtype and torch.equal(g, w)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", [(1, 48), (9, 4096), (16, 4096), (16, 14336), (3, 40000), (16, 1040)])
def test_quantize_rows_kernel_is_bitwise_quantize_act_per_token(dev, M, K, x_dtype):
    """The row quantization ahead of the small-M product past 8 rows:
    int8 values and float32 scales bitwise quant.quantize_act_per_token,
    from row-strided x with a zero row and rows on .5 ties, at K from 48 to
    40,000 (more than one load of registers a thread)."""
    gen = torch.Generator(device=dev).manual_seed(90 + M)
    x, _ = _small_group_inputs(gen, M, (16,), K, x_dtype, True)
    before = gemm.w8a8_matmul.quantize_launches
    xq, xs = gemm.quantize_rows(x)
    assert gemm.w8a8_matmul.quantize_launches == before + 1
    want_q, want_s = quant.quantize_act_per_token(x)
    torch.cuda.synchronize()
    assert torch.equal(xq, want_q) and torch.equal(xs.view(torch.int32), want_s.reshape(-1).view(torch.int32))


def test_w8a8_small_group_past_8_rows_quantizes_apart_and_replays(dev):
    """Past QUANTIZE_IN_KERNEL_MAX rows a group is the row quantization, then
    the product as its programmatic dependent: the profiler sees those two
    kernels and no other, and a CUDA graph that captured them quantizes the
    x it finds at each replay, bitwise the plain group."""
    gen = torch.Generator(device=dev).manual_seed(41)
    M = gemm.QUANTIZE_IN_KERNEL_MAX + 8
    x, weights = _small_group_inputs(gen, M, (14336, 14336), 4096, torch.bfloat16, False)
    quant.w8a8_linear_group(x, weights)
    torch.cuda.synchronize()
    kernels = device_kernels(lambda: quant.w8a8_linear_group(x, weights))
    assert len(kernels) == 2, kernels
    assert sorted("w8a8_small_mma_kernel" in k for k in kernels) == [False, True], kernels
    assert sorted("w8a8_quantize_rows_kernel" in k for k in kernels) == [False, True], kernels
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = quant.w8a8_linear_group(x, weights)
    for scale in (1.0, -0.25, 3.0):
        x.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        want = quant.w8a8_linear_group(x, weights, plain=True)
        assert all(torch.equal(g, w) for g, w in zip(outs, want))


def test_w8a8_small_group_is_one_launch_and_replays(dev):
    """A group call is one launch (the counter, and the profiler sees
    w8a8_small_mma_kernel and nothing else: no elementwise quantization), and
    a CUDA graph that captured it quantizes the x it finds at each replay."""
    gen = torch.Generator(device=dev).manual_seed(40)
    x, weights = _small_group_inputs(gen, 2, (14336, 14336), 4096, torch.bfloat16, False)
    quant.w8a8_linear_group(x, weights)  # builds the kernel outside the capture
    torch.cuda.synchronize()
    kernels = device_kernels(lambda: quant.w8a8_linear_group(x, weights))
    assert len(kernels) == 1 and "w8a8_small_mma_kernel" in kernels[0], kernels
    graph = torch.cuda.CUDAGraph()
    before = gemm.w8a8_matmul.small_launches
    with torch.cuda.graph(graph):
        outs = quant.w8a8_linear_group(x, weights)
    assert gemm.w8a8_matmul.small_launches == before + 1
    for scale in (1.0, -0.25):
        x.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        want = quant.w8a8_linear_group(x, weights, plain=True)
        assert all(torch.equal(g, w) for g, w in zip(outs, want))


@pytest.mark.parametrize("B,rows,R,start", [
    *((4, 128, 4608, start) for start in [16000, [5, 64, 4700, 32000], [0, 63, 4607, 4608], [-1, 2, 9000, 70]]),
    # the serving pool's decode-only buffers (sink rows 72, R = 384)
    (4, 72, 384, [63, 383, 384, 32511]),
    (8, 72, 384, [10, 64, 383, 384, 767, 768, 32511, 5000]),
])
def test_write_streaming_rows_kernel_reads_strided_rows(dev, B, rows, R, start):
    """The decode step's streaming write: K and V rows of the last 4 of 8 KV
    heads, read in place as ``transpose`` views of [B, 1, Hkv, D]
    projections, in one launch at B = 4 and 8 (mixed starts, the ring's wrap
    at R = 4608 and at the pool's 384, starts before the sink is full);
    bitwise equal to the plain version."""
    gen = torch.Generator(device=dev).manual_seed(13)
    H, HKV, sink = 4, 8, 64
    bufs = [randn(gen, B, H, rows, 128), randn(gen, B, H, rows, 128),
            randn(gen, B, H, R, 128), randn(gen, B, H, R, 128)]
    refs = [b.clone() for b in bufs]
    kproj, vproj = randn(gen, B, 1, HKV, 128), randn(gen, B, 1, HKV, 128)
    krow, vrow = kproj[:, :, HKV - H :].transpose(1, 2), vproj[:, :, HKV - H :].transpose(1, 2)
    assert not krow.is_contiguous()
    st = torch.as_tensor(start, dtype=torch.int32, device=dev).clamp_min(0)
    before = inplace.write_streaming_rows.launches
    inplace.write_streaming_rows(*bufs, krow, vrow, st, sink)
    assert inplace.write_streaming_rows.launches == before + 1
    inplace.write_streaming_rows_plain(*refs, krow, vrow, st, sink)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bufs, refs))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    k = randn(gen, 1, 2, 256, 128)
    with pytest.raises(ValueError):  # float32
        flash.full_cache_attention(torch.zeros(1, 4, 4, 128, device=dev), k, k, 0)
    with pytest.raises(ValueError, match="head_dim"):  # head_dim 96: not an instantiated head_dim
        flash.full_cache_attention(randn(gen, 1, 4, 4, 96), randn(gen, 1, 2, 256, 96),
                                   randn(gen, 1, 2, 256, 96), 0)
    with pytest.raises(ValueError):  # not contiguous
        flash.full_cache_attention(randn(gen, 1, 4, 8, 128)[:, :, ::2], k, k, 0)
    with pytest.raises(ValueError):  # 16 query heads per KV head at decode
        flash.full_cache_attention(randn(gen, 1, 1, 16, 128), k[:, :1], k[:, :1], 0)
    with pytest.raises(ValueError):  # valid counts at prefill
        flash.full_cache_attention(randn(gen, 1, 4, 4, 128), k, k, 0, valid=torch.ones(1, device=dev))
    with pytest.raises(ValueError):  # row of another shape
        inplace.write_row(k, randn(gen, 1, 1, 1, 128), 0)
    # the INT4 and int8 kernels
    kq, ks = quant.quantize_int4_paired(k)
    q = randn(gen, 1, 4, 4, 128)
    with pytest.raises(ValueError):  # packed cache handed over as bf16
        flash.full_cache_attention_q4(q, k, ks, k, ks, 0)
    with pytest.raises(ValueError):  # scales in the JAX cache's 8-row layout
        flash.full_cache_attention_q4(q, kq, torch.cat([ks, ks], dim=2), kq, torch.cat([ks, ks], dim=2), 0)
    with pytest.raises(ValueError):  # float32 row
        inplace.write_q4_token(kq, ks, torch.zeros(1, 2, 1, 128, device=dev), 0)
    with pytest.raises(ValueError):  # a row stride the kernel's 8-byte loads cannot follow
        inplace.write_q4_token(kq, ks, randn(gen, 1, 1, 2, 130)[..., 1:129].transpose(1, 2), 0)
    with pytest.raises(ValueError):  # K and V rows of different strides
        inplace.write_q4_token(kq, ks, randn(gen, 1, 2, 1, 128), 0, kq.clone(), ks.clone(),
                               randn(gen, 1, 1, 2, 128).transpose(1, 2))
    with pytest.raises(ValueError):  # streaming rows whose channels are not contiguous
        inplace.write_streaming_rows(k, k, k, k, randn(gen, 1, 128, 1, 2).transpose(1, 3), k[:, :, :1], 0, 64)
    # the small-M linear
    xb = randn(gen, 2, 4096)
    w8 = [(torch.zeros(64, 4096, dtype=torch.int8, device=dev), torch.ones(64, device=dev))]
    with pytest.raises(ValueError):  # four weights in one group
        gemm.w8a8_small_group(xb, w8 * 4)
    with pytest.raises(ValueError):  # more rows than SMALL_M_MAX
        gemm.w8a8_small_group(randn(gen, gemm.SMALL_M_MAX + 1, 4096), w8)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        gemm.w8a8_small_group(randn(gen, 2, 4100)[:, 2:4098], w8)
    with pytest.raises(ValueError):  # a weight of another K
        gemm.w8a8_small_group(xb, [(torch.zeros(64, 2048, dtype=torch.int8, device=dev), torch.ones(64, device=dev))])
    x8 = torch.zeros(4, 24, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # K not a multiple of 16
        gemm.w8a8_matmul(x8, torch.ones(4, 1, device=dev), x8, torch.ones(4, device=dev))
    x8 = torch.zeros(4, 32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # float16 output
        gemm.w8a8_matmul(x8, torch.ones(4, 1, device=dev), x8, torch.ones(4, device=dev), torch.float16)


# --- serving: the pool step from a graph, sampling inside it -----------------


SERVE_CFG = ModelConfig(vocab_size=2048, hidden_size=1024, intermediate_size=2048, num_layers=3,
                        num_heads=16, num_kv_heads=4, head_dim=128, rope_theta=500000.0)
SERVE_DUO = DuoConfig(sink_size=64, recent_size=256, num_full_kv_heads=(2, 4, 1),
                      max_cache_size=4096, prefill_chunk_size=512)


def _serve_params(kv_quant):
    if kv_quant == "int4":
        return quant.init_params_w8a8_random(SERVE_CFG, seed=0, device="cuda", quantize_embeds=True)
    return llama.init_params(SERVE_CFG, seed=0, device="cuda")


class _EagerStep:
    """Stands in for a captured pool step: ``replay`` runs the step eagerly."""

    def __init__(self, engine, bucket, sample):
        self.engine, self.bucket, self.sample = engine, bucket, sample

    def replay(self):
        with torch.no_grad():
            self.engine._pool_step(self.bucket, self.sample)


def _eager_serving(params, kv_quant, **kw):
    from duo_attention_tpu_torch import ServingEngine

    eng = ServingEngine(params, SERVE_CFG, SERVE_DUO, kv_quant=kv_quant, device="cuda", **kw)
    eng.pool_graph = lambda bucket, sample: (_EagerStep(eng, bucket, sample), False)
    return eng


def _serve(eng, requests):
    from duo_attention_tpu_torch import Request

    for rid, (plen, n, sp) in requests.items():
        prompt = np.random.default_rng(rid).integers(0, SERVE_CFG.vocab_size, plen)
        eng.submit(Request(rid=rid, prompt_ids=prompt, max_new_tokens=n, sampling=sp))
    return {r.rid: r.generated for r in eng.run()}


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_serving_pool_graph_equals_the_eager_pool_step(dev, kv_quant):
    """The ServingEngine's pool step replayed from its graphs (greedy and
    sampled, B = 3 with [B] lengths, slots reused, a request admitted into a
    freed slot after the graphs were captured) gives the eager pool step's
    tokens and leaves the same pool cache, bitwise."""
    from duo_attention_tpu_torch import SamplingParams, ServingEngine

    params = _serve_params(kv_quant)
    sp = SamplingParams(temperature=0.9, top_p=0.95, top_k=40, seed=5)
    first = {0: (700, 12, None), 1: (150, 20, sp), 2: (1300, 9, None), 3: (60, 14, None)}
    later = {4: (900, 10, SamplingParams(temperature=1.1, seed=6)), 5: (40, 6, None)}
    graph = ServingEngine(params, SERVE_CFG, SERVE_DUO, max_batch_size=3, kv_quant=kv_quant, decode_burst=4,
                          device="cuda")
    eager = _eager_serving(params, kv_quant, max_batch_size=3, decode_burst=4)
    assert _serve(graph, first) == _serve(eager, first)
    captured = dict(graph._graphs)
    assert any(s for _, s in captured) and any(not s for _, s in captured)
    assert _serve(graph, later) == _serve(eager, later)
    for key, g in captured.items():  # the splices wrote in place: the graphs were replayed, not captured anew
        assert graph._graphs[key] is g
    for name in graph.cache.BUFFERS:
        for a, b in zip(getattr(graph.cache, name), getattr(eager.cache, name)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    assert torch.equal(graph.cache.length, eager.cache.length)
    assert torch.equal(graph.samp_keys, eager.samp_keys)


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_serving_freed_slot_past_the_bucket_leaves_live_rows_unchanged(dev, kv_quant):
    """A request finishes at admission and frees its slot with a device
    length of 3000; the live row then decodes at bucket 512, with the freed
    row inactive and past the bucket. The live row's tokens equal a pool in
    which the other slot was never used."""
    from duo_attention_tpu_torch import ServingEngine

    params = _serve_params(kv_quant)
    runs = []
    for requests in ({0: (100, 40, None), 1: (3000, 1, None)}, {0: (100, 40, None)}):
        eng = ServingEngine(params, SERVE_CFG, SERVE_DUO, max_batch_size=2, kv_quant=kv_quant, decode_burst=8,
                            device="cuda")
        runs.append(_serve(eng, requests)[0])
        if len(requests) == 2:
            assert int(eng.cache.length[1]) == 3000 and max(b for b, _ in eng._graphs) == 512
    assert runs[0] == runs[1]


def test_sampled_step_captures_reproduces_and_draws_anew(dev):
    """``sample_tokens_rowkeys`` captured into a CUDA graph on static logits
    and keys: each replay advances the keys in place and draws anew; the
    keys put back to the seed's reproduce the first draw; the draws and keys
    equal the same function run eagerly on the CPU."""
    from duo_attention_tpu_torch.ops import sampling

    B, V = 4, 128256
    gen = torch.Generator(device=dev).manual_seed(21)
    logits = torch.randn((B, V), generator=gen, device=dev) * 0.1  # flat: draws spread
    seed_keys = sampling.split(sampling.prng_key(3, dev), B)
    keys = seed_keys.clone()
    temp = torch.tensor([1.0, 0.7, 1.3, 1.0], device=dev)
    top_p = torch.tensor([1.0, 0.95, 0.9, 1.0], device=dev)
    top_k = torch.tensor([0, 0, 1000, 50], dtype=torch.int32, device=dev)
    tok = torch.zeros(B, dtype=torch.long, device=dev)

    def step():
        nxt, nk = sampling.sample_tokens_rowkeys(logits, keys, temp, top_p, top_k)
        tok.copy_(nxt)
        keys.copy_(nk)

    step()  # builds everything outside the capture
    keys.copy_(seed_keys)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        g = torch.cuda.CUDAGraph()
        g.capture_begin()
        step()
        g.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    draws, key_states = [], []
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        draws.append(tok.clone())
        key_states.append(keys.clone())
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    assert not torch.equal(key_states[0], key_states[1])
    keys.copy_(seed_keys)
    g.replay()
    assert torch.equal(tok, draws[0])
    # the CPU's eager run: the same keys bitwise, the same tokens
    cpu_keys = seed_keys.cpu()
    for i in range(3):
        want, cpu_keys = sampling.sample_tokens_rowkeys(logits.cpu(), cpu_keys, temp.cpu(), top_p.cpu(), top_k.cpu())
        assert torch.equal(cpu_keys, key_states[i].cpu())
        assert torch.equal(want, draws[i].cpu())


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_engine_sampled_graph_equals_the_eager_loop(dev, kv_quant):
    """DuoEngine.generate(sampling=...) on the card (bursts of 8: the first
    step eager, then the captured sampled step) gives the tokens of the same
    key sequence run as a loop of eager steps, and a seed reproduces them."""
    from duo_attention_tpu_torch import SamplingParams
    from duo_attention_tpu_torch.ops import sampling

    params = _serve_params(kv_quant)
    engine = DuoEngine(params, SERVE_CFG, SERVE_DUO, device="cuda", kv_quant=kv_quant, decode_burst=8)
    ids = np.random.default_rng(3).integers(0, SERVE_CFG.vocab_size, (1, 900))
    sp = SamplingParams(temperature=1.0, top_p=0.95, seed=9)
    steps = 20
    tokens, _ = engine.generate(ids, steps, sampling=sp)
    again, _ = engine.generate(ids, steps, sampling=sp)
    assert np.array_equal(tokens, again)

    cache, logits = engine.prefill(ids)
    one = lambda v, dt: torch.full((1,), v, dtype=dt, device=dev)  # noqa: E731
    temp, top_p, top_k = one(1.0, torch.float32), one(0.95, torch.float32), one(0, torch.int32)
    key, sub = sampling.split(sampling.prng_key(9, dev))
    token = sampling.sample_tokens(logits.float(), sub, temp, top_p, top_k)
    bucket = engine.bucket_for(900 + steps)
    eager = []
    with torch.no_grad():
        for burst in (8, 8, 4):
            key, sub = sampling.split(key)
            sub = sub.clone()
            for _ in range(burst):
                eager.append(int(token[0]))
                token = engine._next_token(cache, token, bucket, (sub, temp, top_p, top_k))
    assert tokens[0].tolist() == eager


@pytest.mark.parametrize("B", [4, 8])
def test_streaming_decode_at_the_pool_shapes(dev, B):
    """The streaming decode over the serving pool's decode-only buffers (sink
    rows 72, ring R = 384 at sink 64 / recent 256) at [B] lengths, some past
    the ring's wrap and one before the sink is full."""
    gen = torch.Generator(device=dev).manual_seed(30 + B)
    Hs, G = 4, 4
    q = randn(gen, B, 1, Hs * G, 128, mul=Q_PEAK)
    bufs = [randn(gen, B, Hs, 72, 128), randn(gen, B, Hs, 72, 128),
            randn(gen, B, Hs, 384, 128), randn(gen, B, Hs, 384, 128)]
    cs = torch.tensor([16000, 10, 383, 384, 32511, 700, 65, 5000][:B], dtype=torch.int32, device=dev)
    got = flash.streaming_cache_attention(q, *bufs, cs, cs + 1, 64, 256)
    want = flash.streaming_cache_attention_plain(q, *bufs, cs, cs + 1, 64, 256)
    assert_bf16_close(got, want)


# ---------------------------------------------------------------------------
# Gate training: the W8A8 straight-through linear and the two-way forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [17, 2048])
def test_w8a8_ste_on_the_tiled_kernel_equals_the_plain_path(dev, M):
    """With a gradient, w8a8_linear_group runs the tiled kernel (one launch a
    weight) and equals the plain version bitwise; its straight-through
    backward (a cuBLAS bf16 product) is the same on both paths."""
    gen = torch.Generator(device=dev).manual_seed(11)
    K = 4096
    weights = [quant.quantize_weight_int8(torch.randn((n, K), generator=gen, device=dev) / 64) for n in (4096, 1024)]
    x = torch.randn((1, M, K), generator=gen, device=dev).to(torch.bfloat16)
    cts = [torch.randn((1, M, wq.shape[0]), generator=gen, device=dev).to(torch.bfloat16) for wq, _ in weights]
    grads, outs = [], []
    for plain in (False, True):
        xg = x.clone().requires_grad_(True)
        before = gemm.w8a8_matmul.tiled_launches
        got = quant.w8a8_linear_group(xg, weights, torch.bfloat16, plain)
        assert gemm.w8a8_matmul.tiled_launches - before == (0 if plain else len(weights))
        torch.autograd.backward(got, cts)
        grads.append(xg.grad)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().max() > 0


def test_two_way_gate_gradients_kernel_path_equal_plain_path(dev):
    """forward_two_way at the 8B width (2 layers, random int8 weights), S =
    1,024: teacher, student and the gate gradient on the tiled kernel equal
    the plain path's (rtol 1e-5; the products are bitwise, the rest runs the
    same torch ops), and the kernel path launches 21 tiled products a layer
    (teacher 7, student 7, the student's recompute 7) and no plain one."""
    import dataclasses

    from duo_attention_tpu_torch import PRESETS

    cfg = dataclasses.replace(PRESETS["Llama-3-8B-Instruct-Gradient-1048k"], num_layers=2, vocab_size=1024)
    params = quant.init_params_w8a8_random(cfg, seed=0, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    g0 = torch.full((cfg.num_layers, cfg.num_kv_heads), 0.5, device=dev)
    g0[0, 0], g0[1, 1] = 0.0, 1.0  # on the clip's bounds
    runs = []
    for plain in (False, True):
        gates = g0.clone().requires_grad_(True)
        tiled, plain_calls = gemm.w8a8_matmul.tiled_launches, gemm.w8a8_matmul_plain.cuda_calls
        t, s = llama.forward_two_way(params, gates, cfg, 64, 256, ids, block_k=512, remat=True, plain=plain)
        ((t.float() - s.float()) ** 2).mean().backward()
        torch.cuda.synchronize()
        if not plain:
            assert gemm.w8a8_matmul.tiled_launches - tiled == 21 * cfg.num_layers
            assert gemm.w8a8_matmul_plain.cuda_calls == plain_calls
        runs.append((t, s, gates.grad))
    for a, b in zip(*runs):
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=0), (a - b).abs().max()
    assert runs[0][2].abs().max() > 0


# ---------------------------------------------------------------------------
# head_dim 64: every attention kernel's D = 64 instantiation and the writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Hq,Hkv,T,cs,bucket", [
    (2, 100, 8, 8, 1024, [0, 500], 1024),  # ragged query tile, G = 1
    (1, 1000, 8, 2, 2048, 517, 2048),  # S not a multiple of the query tile, odd start
    (1, 65, 4, 4, 512, 0, 512),  # the second warpgroup holds one row
    (4, 256, 16, 2, 2048, [0, 100, 1024, 1792], 2048),  # B = 4, G = 8
    (1, 4096, 8, 4, 16384, 12000, 16384),  # a chunk of the constructed circuit's shape
    (1, 1, 16, 2, 512, 300, 512),  # decode, G = 8, a block a tile
    (3, 1, 8, 4, 768, [0, 766, 5], 768),  # decode, per-sequence lengths
    (1, 1, 16, 4, 32768, 32767, 32768),  # decode, every tile full
    (1, 1, 16, 4, 16384, 16001, 16384),  # decode, an odd tail
    (3, 1, 16, 2, 8192, [5, 4096, 8191], 8192),  # decode, mixed lengths: shares cross rows
    (1, 1, 12, 4, 1536, 0, 1536),  # decode, G = 3, one key in all
])
def test_full_cache_attention_kernel_at_head_dim_64(dev, B, S, Hq, Hkv, T, cs, bucket):
    gen = torch.Generator(device=dev).manual_seed(40)
    q = randn(gen, B, S, Hq, 64, mul=Q_PEAK)
    k, v = randn(gen, B, Hkv, T, 64), randn(gen, B, Hkv, T, 64)
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    before = flash.full_cache_attention.prefill_launches + flash.full_cache_attention.decode_launches
    got = flash.full_cache_attention(q, k, v, cs, bucket=bucket)
    assert flash.full_cache_attention.prefill_launches + flash.full_cache_attention.decode_launches == before + 1
    want = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket)
    torch.cuda.synchronize()
    assert_bf16_close(got, want)


@pytest.mark.parametrize("B,S,Hq,Hs,sink,recent,chunk,R,cs", [
    (2, 64, 8, 4, 4, 8, 64, 128, [64, 300]),  # wrapped ring
    (1, 130, 2, 2, 0, 16, 130, 512, 1000),  # no sink, ragged tile, G = 1
    (1, 256, 8, 2, 64, 256, 256, 512, 1900),  # tokens cross the wrap
    (1, 100, 8, 2, 64, 256, 128, 512, 10),  # cs < sink
    (2, 1, 16, 2, 64, 256, 4096, 4608, [3, 9000]),  # decode, G = 8
    (1, 1, 16, 4, 64, 256, 4096, 4608, 4700),  # decode across slot R
    (4, 1, 16, 4, 64, 256, 4096, 4608, [5, 64, 4700, 32000]),  # decode, B = 4, empty splits
    (2, 1, 8, 2, 0, 256, 4096, 4608, [300, 16000]),  # decode, no sink
    (1, 1, 4, 1, 128, 2048, 4096, 4608, 16000),  # decode, a window past one tile a warp
])
def test_streaming_cache_attention_kernel_at_head_dim_64(dev, B, S, Hq, Hs, sink, recent, chunk, R, cs):
    gen = torch.Generator(device=dev).manual_seed(41)
    q = randn(gen, B, S, Hq, 64, mul=Q_PEAK)
    bufs = [randn(gen, B, Hs, sink + chunk, 64), randn(gen, B, Hs, sink + chunk, 64),
            randn(gen, B, Hs, R, 64), randn(gen, B, Hs, R, 64)]
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.streaming_cache_attention(q, *bufs, cs, cs + S, sink, recent)
    want = flash.streaming_cache_attention_plain(q, *bufs, cs, cs + S, sink, recent)
    torch.cuda.synchronize()
    assert_bf16_close(got, want)


@pytest.mark.parametrize("B,S,Hq,Hkv,T,cs,bucket", [
    (2, 100, 8, 8, 1024, [0, 500], 1024),  # ragged query tile, G = 1
    (1, 70, 4, 2, 512, 101, 512),  # odd start: the last key shares a byte row with an unseen one
    (1, 300, 8, 4, 2048, 517, 2048),  # odd start, the diagonal tile splits a pair
    (4, 256, 16, 4, 2048, [0, 301, 1024, 1700], 2048),  # B = 4, mixed lengths and parities
    (1, 1, 16, 2, 512, 300, 512),  # decode, G = 8, one split
    (1, 1, 8, 4, 512, 301, 0),  # decode, odd position
    (3, 1, 8, 4, 4096, [0, 4095, 1500], 4096),  # decode, some splits empty
    (2, 1, 4, 4, 32768, [20000, 32767], 32768),  # decode, 32 splits
    (1, 1, 12, 4, 1536, 1400, 0),  # decode, G = 3
    (1, 1, 16, 4, 128, 57, 100),  # a span below one tile
])
def test_full_cache_attention_q4_kernel_at_head_dim_64(dev, B, S, Hq, Hkv, T, cs, bucket):
    gen = torch.Generator(device=dev).manual_seed(42)
    q = randn(gen, B, S, Hq, 64, mul=Q_PEAK)
    kq, ks = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 64))
    vq, vs = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 64))
    kq, ks, vq, vs = (t.contiguous() for t in (kq, ks, vq, vs))
    cs = torch.as_tensor(cs, dtype=torch.int32, device=dev)
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs, bucket=bucket)
    want = flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, cs, bucket=bucket)
    torch.cuda.synchronize()
    assert_q4_close(got, want)


@pytest.mark.parametrize("S,cs", [(1, 1501), (1, [700, 2047]), (301, 500)])
def test_full_cache_attention_q4_at_head_dim_64_never_reads_past_the_frontier(dev, S, cs):
    """NaN scales and 0xF nibbles at every slot past the last query (an odd
    frontier's pair row holds a visible key and a poisoned one): the kernel on
    the poisoned cache equals the plain version on a clean one."""
    gen = torch.Generator(device=dev).manual_seed(43)
    cs_t = torch.as_tensor(cs, dtype=torch.int32, device=dev).reshape(-1)
    B, Hq, Hkv, T = cs_t.numel(), 16, 4, 2048
    q = randn(gen, B, S, Hq, 64, mul=Q_PEAK)
    kq, ks = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 64))
    vq, vs = quant.quantize_int4_paired(randn(gen, B, Hkv, T, 64))
    kq, ks, vq, vs = (t.contiguous() for t in (kq, ks, vq, vs))
    past = torch.arange(T, device=dev)[None] >= cs_t[:, None] + S  # [B, T]
    clean = [t.clone() for t in (kq, ks, vq, vs)]
    for b in range(B):
        for packed, kept in ((kq, clean[0]), (vq, clean[2])):
            kept[b, :, past[b, 0::2]] = 0
            packed[b, :, past[b, 0::2]] = 0xFF
            packed[b, :, past[b, 1::2] & ~past[b, 0::2]] |= 0xF0
        for scales in (ks, vs):
            scales[b, :, 0::2][..., past[b, 0::2]] = float("nan")
            scales[b, :, 1::2][..., past[b, 1::2]] = float("nan")
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, cs_t, bucket=T)
    want = flash.full_cache_attention_q4_plain(q, *clean, cs_t, bucket=T)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert_q4_close(got, want)


@pytest.mark.parametrize("S", [1, 192])
def test_attention_kernels_at_head_dim_64_capture_into_a_cuda_graph(dev, S):
    """The D = 64 launches read nothing back either: captured twice each and
    replayed, the three wrappers give their eager results bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(44)
    B, Hq, Hkv, T, sink, recent, R = 2, 8, 2, 4096, 64, 256, 512
    q = randn(gen, B, S, Hq, 64, mul=Q_PEAK)
    k, v = randn(gen, B, Hkv, T, 64), randn(gen, B, Hkv, T, 64)
    bufs = [randn(gen, B, Hkv, sink + 256, 64), randn(gen, B, Hkv, sink + 256, 64),
            randn(gen, B, Hkv, R, 64), randn(gen, B, Hkv, R, 64)]
    cache = [t.contiguous() for t in (*quant.quantize_int4_paired(k), *quant.quantize_int4_paired(v))]
    cs = torch.tensor([3000, 3800], dtype=torch.int32, device=dev)
    tot = cs + S
    calls = lambda: (flash.full_cache_attention(q, k, v, cs, bucket=T),  # noqa: E731
                     flash.streaming_cache_attention(q, *bufs, cs, tot, sink, recent),
                     flash.full_cache_attention_q4(q, *cache, cs, bucket=T))
    want = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(2):
            got = calls()
    for g in got:
        g.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("pos", [0, 511, [3, 0, 511], [-4, 1000, 17]])
def test_writes_at_head_dim_64(dev, pos):
    """write_row (the pair from strided rows), write_streaming_rows and
    write_q4_token (the pair) at D = 64: one launch each, bitwise the plain
    versions."""
    gen = torch.Generator(device=dev).manual_seed(45)
    B, D = 3, 64
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    kbuf, vbuf = randn(gen, B, 2, 512, D), randn(gen, B, 2, 512, D)
    kproj, vproj = randn(gen, B, 1, 4, D), randn(gen, B, 1, 4, D)
    krow, vrow = kproj[:, :, :2].transpose(1, 2), vproj[:, :, :2].transpose(1, 2)
    refs = kbuf.clone(), vbuf.clone()
    inplace.write_row(kbuf, krow, pos, vbuf, vrow)
    inplace.write_row_plain(refs[0], krow, pos, refs[1], vrow)
    assert torch.equal(kbuf, refs[0]) and torch.equal(vbuf, refs[1])

    sbufs = [randn(gen, B, 2, 64 + 16, D), randn(gen, B, 2, 64 + 16, D),
             randn(gen, B, 2, 128, D), randn(gen, B, 2, 128, D)]
    srefs = [b.clone() for b in sbufs]
    st = pos.clamp_min(0)
    inplace.write_streaming_rows(*sbufs, krow, vrow, st, 64)
    inplace.write_streaming_rows_plain(*srefs, krow, vrow, st, 64)
    assert all(torch.equal(a, b) for a, b in zip(sbufs, srefs))

    T2 = 512
    qbufs = [torch.randint(0, 256, (B, 2, T2, D), generator=gen, device=dev, dtype=torch.uint8),
             randn(gen, B, 2, 4, T2)]
    qbufs += [torch.randint(0, 256, (B, 2, T2, D), generator=gen, device=dev, dtype=torch.uint8),
              randn(gen, B, 2, 4, T2)]
    qrefs = [b.clone() for b in qbufs]
    before = inplace.write_q4_token.launches
    inplace.write_q4_token(qbufs[0], qbufs[1], krow, pos, qbufs[2], qbufs[3], vrow)
    assert inplace.write_q4_token.launches == before + 1
    inplace.write_q4_token_plain(qrefs[0], qrefs[1], krow, pos, qrefs[2], qrefs[3], vrow)
    torch.cuda.synchronize()
    assert torch.equal(qbufs[0], qrefs[0]) and torch.equal(qbufs[2], qrefs[2])
    assert torch.equal(qbufs[1].view(torch.int16), qrefs[1].view(torch.int16))
    assert torch.equal(qbufs[3].view(torch.int16), qrefs[3].view(torch.int16))


# A Mixtral at head_dim 64 (TINY_MIXTRAL's family, widened to the kernels' shapes): its MoE MLP
# runs beside the D = 64 attention kernels and the W8A8 products
MIXTRAL_D64 = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=8,
                          num_kv_heads=4, head_dim=64, rope_theta=1e6, model_type="mixtral", num_local_experts=4,
                          num_experts_per_tok=2)
MIXTRAL_D64_DUO = DuoConfig(sink_size=16, recent_size=64, num_full_kv_heads=(2, 1), max_cache_size=2048,
                            prefill_chunk_size=256)


def _mixtral_d64_params(kv_quant):
    if kv_quant == "int4":
        return quant.init_params_w8a8(MIXTRAL_D64, seed=0, device="cuda", quantize_embeds=True)
    return llama.init_params(MIXTRAL_D64, seed=0, device="cuda")


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_mixtral_head_dim_64_decode_graph_equals_the_eager_loop(dev, kv_quant):
    """The MoE model's captured decode step (bursts of 8) gives the eager
    forward_chunk loop's greedy tokens, cache length and launch counts, in
    both formats, through the D = 64 kernels."""
    cfg, duo = MIXTRAL_D64, MIXTRAL_D64_DUO
    params = _mixtral_d64_params(kv_quant)
    engine = DuoEngine(params, cfg, duo, device="cuda", kv_quant=kv_quant, decode_burst=8)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 700))
    steps = 20
    cache, logits = engine.prefill(ids)
    before = launches.snapshot()
    tokens, cache = engine.decode_tokens(cache, torch.argmax(logits, -1), steps, length=700)
    graph_counts = [a - b for a, b in zip(launches.snapshot(), before)]

    eager_cache, logits = engine.prefill(ids)
    token = torch.argmax(logits, -1)
    bucket = engine.bucket_for(700 + steps)
    eager = []
    before = launches.snapshot()
    with torch.no_grad():
        for _ in range(steps):
            eager.append(int(token[0]))
            hidden, eager_cache = llama.forward_chunk(params, cfg, duo, eager_cache, token[:, None], 1,
                                                      full_bucket=bucket)
            token = torch.argmax(llama.logits_at(params, hidden, 0), dim=-1)
    eager_counts = [a - b for a, b in zip(launches.snapshot(), before)]
    assert tokens[0].tolist() == eager
    assert int(cache.length) == int(eager_cache.length) == 700 + steps
    assert graph_counts == eager_counts and sum(graph_counts) > 0


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_mixtral_head_dim_64_kernel_route_equals_the_plain_route(dev, kv_quant, monkeypatch):
    """Prefill (two chunks and a ragged tail) and 6 teacher-forced decode
    steps of the MoE model through the kernels and through the plain
    versions: the logits within chip_smoke.py's phase 5 bound (5% of the
    largest plain logit + 0.05; twice that in W8A8KV4), and the plain route
    makes no kernel launch. The plain route's router is handed the experts
    the kernel route's picked, call for call (weighted by its own logits):
    top-k routing is a step function, and where two router logits tie a
    last-bit difference picks another expert and moves that token by a
    whole expert's output (as chip_smoke.py's ``_PinnedRouting``)."""
    from duo_attention_tpu_torch.cache import init_cache, init_cache_q4

    chosen, state = [], {"replay": False, "calls": 0}
    kept = llama.moe_router

    def pinned(layer, x, top_k):
        if not state["replay"]:
            combine = kept(layer, x, top_k)
            chosen.append(torch.topk(combine, top_k, dim=-1).indices)  # the nonzero weights
            return combine
        topi = chosen[state["calls"]]
        state["calls"] += 1
        logits = x.float() @ layer["moe_gate"].float()
        return torch.zeros_like(logits).scatter_(-1, topi, torch.softmax(logits.gather(-1, topi), dim=-1))

    monkeypatch.setattr(llama, "moe_router", pinned)
    cfg, duo = MIXTRAL_D64, MIXTRAL_D64_DUO
    params = _mixtral_d64_params(kv_quant)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 600))
    new_cache = init_cache_q4 if kv_quant == "int4" else init_cache
    feed = np.random.default_rng(2).integers(0, cfg.vocab_size, 6)

    def run(plain):
        cache = new_cache(cfg, duo, 1, torch.bfloat16, dev)
        out = []
        with torch.no_grad():
            for off in range(0, 600, 256):
                chunk = ids[:, off : off + 256]
                n = chunk.shape[1]
                hidden, cache = llama.forward_chunk(
                    params, cfg, duo, cache, torch.as_tensor(np.pad(chunk, ((0, 0), (0, 256 - n))), device=dev),
                    n, full_bucket=1024, plain=plain)
            out.append(llama.logits_at(params, hidden, n - 1, plain=plain))
            for t in feed:
                hidden, cache = llama.forward_chunk(params, cfg, duo, cache, torch.tensor([[int(t)]], device=dev), 1,
                                                    full_bucket=1024, plain=plain)
                out.append(llama.logits_at(params, hidden, 0, plain=plain))
        return torch.cat(out).float()

    def counts(kind):  # the kernels' launches, or the plain versions' calls on CUDA tensors
        return [getattr(fn, a) for fn, a in launches.counters().values() if (a == "cuda_calls") == (kind == "plain")]

    before = counts("kernel"), counts("plain")
    kern = run(False)
    assert counts("plain") == before[1] and sum(counts("kernel")) > sum(before[0])
    before = counts("kernel"), counts("plain")
    state["replay"] = True
    plain = run(True)
    assert state["calls"] == len(chosen) and counts("kernel") == before[0] and sum(counts("plain")) > sum(before[1])
    bound = (0.1 if kv_quant == "int4" else 0.05) * float(plain.abs().max()) + 0.05
    assert bool(torch.isfinite(kern).all())
    assert float((kern - plain).abs().max()) <= bound


# ---------------------------------------------------------------------------
# Tensor parallelism: the shapes a rank gives the kernels, and the mesh path on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,cs", [(1, 3000), (200, 1000)])
@pytest.mark.parametrize("Hkv", [1, 2, 3])
def test_attention_kernels_at_a_ranks_head_counts(dev, Hkv, S, cs):
    """A TP = 2 rank of the 8B model holds 1-3 full and 1-3 streaming KV
    heads of a head-sharded layer (query group 4): every attention kernel,
    prefill and decode, at those counts against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(12)
    G, T, sink, recent, chunk, R = 4, 4096, 64, 256, 256, 512
    q = randn(gen, 1, S, Hkv * G, 128, mul=Q_PEAK)
    k, v = randn(gen, 1, Hkv, T, 128), randn(gen, 1, Hkv, T, 128)
    csa = torch.tensor(cs, dtype=torch.int32, device=dev)
    got = flash.full_cache_attention(q, k, v, csa, bucket=T)
    assert_bf16_close(got, flash.full_cache_attention_plain(q, k, v, csa, bucket=T))
    kq, ks = quant.quantize_int4_paired(k)
    vq, vs = quant.quantize_int4_paired(v)
    got = flash.full_cache_attention_q4(q, kq, ks, vq, vs, csa, bucket=T)
    assert_q4_close(got, flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, csa, bucket=T))
    bufs = [randn(gen, 1, Hkv, sink + chunk, 128), randn(gen, 1, Hkv, sink + chunk, 128),
            randn(gen, 1, Hkv, R, 128), randn(gen, 1, Hkv, R, 128)]
    got = flash.streaming_cache_attention(q, *bufs, csa, csa + S, sink, recent)
    torch.cuda.synchronize()
    assert_bf16_close(got, flash.streaming_cache_attention_plain(q, *bufs, csa, csa + S, sink, recent))


@pytest.mark.parametrize("M", [1, 8, 16, 17, 300])
@pytest.mark.parametrize("K", [2048, 7168])
def test_w8a8_int8_input_with_a_cross_rank_scale(dev, K, M):
    """A row shard's product (ops/quant.py::w8a8_linear_row_split): x
    quantized with a per-token scale taken over a wider row than the rank's
    slice (the all_reduce MAX), the int8-input mode of the small-M kernel (M
    <= SMALL_M_MAX) or the tiled one, float32 output, at wo's and w_down's local depths
    at TP = 2: bitwise the plain product."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x = randn(gen, M, K, mul=2.0).float()
    xq, xs = quant._quantize_rows(x, x.abs().amax(-1, keepdim=True) * 1.7)
    wq = torch.randint(-127, 128, (4096, K), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((4096,), generator=gen, device=dev) * 1e-3 + 1e-4
    before = gemm.w8a8_matmul.small_launches, gemm.w8a8_matmul.tiled_launches
    got = gemm.w8a8_matmul(xq, xs, wq, ws, torch.float32)
    small = M <= gemm.SMALL_M_MAX
    assert (gemm.w8a8_matmul.small_launches - before[0], gemm.w8a8_matmul.tiled_launches - before[1]) == (
        (1, 0) if small else (0, 1))
    assert torch.equal(got, gemm.w8a8_matmul_plain(xq, xs, wq, ws, torch.float32))


TP_TEST_CFG = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
                          num_kv_heads=4, head_dim=128, model_type="llama")
TP_TEST_DUO = DuoConfig(sink_size=16, recent_size=64, num_full_kv_heads=(2, 1), max_cache_size=1024,
                        prefill_chunk_size=256)


def _tp_test_params(kv_quant):
    from duo_attention_tpu_torch import init_params, init_params_w8a8

    if kv_quant == "int4":
        return init_params_w8a8(TP_TEST_CFG, seed=3, device="cuda", quantize_embeds=True)
    return init_params(TP_TEST_CFG, seed=3, device="cuda")


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_one_rank_nccl_mesh_captures_and_equals_no_mesh(dev, kv_quant, tmp_path):
    """TP = 1 over NCCL: the mesh path (every layer 'sharded' over one rank,
    its collectives issued) decodes from a captured CUDA graph, NCCL's
    collectives inside it, and gives bit for bit the no-mesh engine's tokens
    and the collectives parallel.mesh reckons a step."""
    from duo_attention_tpu_torch.parallel import dryrun as pdry
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    params = _tp_test_params(kv_quant)
    prompt = np.random.default_rng(4).integers(0, TP_TEST_CFG.vocab_size, (1, 600))
    want, _ = DuoEngine(params, TP_TEST_CFG, TP_TEST_DUO, device="cuda", kv_quant=kv_quant).generate(prompt, 24)
    (got,) = pmesh.run_ranks(pmesh.run_jobs, 1, args=([(pdry.generate_job, (params, TP_TEST_CFG, TP_TEST_DUO,
                                                                             prompt, 24), {"kv_quant": kv_quant})],),
                             device="cuda", timeout_s=300, store_dir=str(tmp_path))
    np.testing.assert_array_equal(got[0]["tokens"], want)
    reckoned = pmesh.collectives_per_step(pmesh.Mesh(1, 1, 0, 0, 0, None, None, 0, "nccl", dev), TP_TEST_CFG,
                                          TP_TEST_DUO, w8a8=kv_quant == "int4")
    assert got[0]["collectives_per_step"] == reckoned


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_two_ranks_on_one_card_over_gloo(dev, kv_quant, tmp_path):
    """TP = 2 over gloo, both ranks on the one card, through the kernels at
    the ranks' head counts (layer 0 split 1 + 1 a rank, layer 1 replicated)
    and the row-split products: fed the one-device engine's greedy tokens
    (teacher-forced), the logits before each of them (the prefill's last,
    then every decode step's) within chip_smoke.py's phase 5 bound of the
    one-device engine's; and the ranks' own greedy tokens equal up to the
    one-device run's first top-2 logit gap below 0.25."""
    from duo_attention_tpu_torch.parallel import dryrun as pdry
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    params = _tp_test_params(kv_quant)
    prompt = np.random.default_rng(5).integers(0, TP_TEST_CFG.vocab_size, (1, 600))
    one = DuoEngine(params, TP_TEST_CFG, TP_TEST_DUO, device="cuda", kv_quant=kv_quant)
    want, gaps = pdry.greedy_gaps(one, prompt, 16)
    ref = pdry.stream_logits(one, prompt, want)[:, 0]  # [16, vocab]
    ranks = pmesh.run_ranks(pmesh.run_jobs, 2, args=([(pdry.generate_job, (params, TP_TEST_CFG, TP_TEST_DUO,
                                                                            prompt, 16),
                                                        {"kv_quant": kv_quant, "force": want})],),
                            device="cuda", timeout_s=300, store_dir=str(tmp_path))
    got = ranks[0][0]
    np.testing.assert_array_equal(got["tokens"], ranks[1][0]["tokens"])
    errs = np.abs(got["logits"][:, 0] - ref).max(axis=-1)
    bounds = (0.1 if kv_quant == "int4" else 0.05) * np.abs(ref).max(axis=-1) + 0.05
    assert (errs <= bounds).all(), (errs, bounds)
    pdry.agree_until_tie(got["tokens"], want, gaps, 0.25, "two ranks on one card")


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_one_rank_nccl_serving_captures_and_equals_no_mesh(dev, kv_quant, tmp_path):
    """ServingEngine(mesh=) over a one-rank NCCL mesh captures its pool
    steps with their collectives and serves three requests (one sampled)
    bit for bit as the no-mesh pool does."""
    from duo_attention_tpu_torch import Request, SamplingParams, ServingEngine
    from duo_attention_tpu_torch.parallel import dryrun as pdry
    from duo_attention_tpu_torch.parallel import mesh as pmesh

    params = _tp_test_params(kv_quant)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, TP_TEST_CFG.vocab_size, n) for n in (300, 70, 180)]
    sampling = {1: SamplingParams(temperature=0.8, top_p=0.95, top_k=50, seed=1)}
    pool = ServingEngine(params, TP_TEST_CFG, TP_TEST_DUO, max_batch_size=2, kv_quant=kv_quant, decode_burst=4,
                         device="cuda")
    for i, p in enumerate(prompts):
        pool.submit(Request(rid=i, prompt_ids=p, max_new_tokens=12, sampling=sampling.get(i)))
    want = {r.rid: list(r.generated) for r in pool.run()}
    (got,) = pmesh.run_ranks(pmesh.run_jobs, 1, args=([(pdry.serve_job, (params, TP_TEST_CFG, TP_TEST_DUO, prompts,
                                                                          12, sampling),
                                                        {"kv_quant": kv_quant, "max_batch_size": 2,
                                                         "decode_burst": 4})],),
                             device="cuda", timeout_s=300, store_dir=str(tmp_path))
    assert got[0] == want
