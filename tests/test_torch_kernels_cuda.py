"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a GPU and nvcc; elsewhere they skip. On a machine with a card
(which need not have jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

chip_smoke.py holds the kernels to the plain versions at the main path's
shapes; these cover the shapes it does not reach: ragged query tiles, query
groups of 1 to 8, no sink, small rings that wrap, per-sequence lengths, decode
split plans with one, full and empty splits, capture into a CUDA graph,
odd and even token parity in the INT4 cache, a poisoned cache past the INT4
frontier, the INT4 decode at query groups of 1 to 8 with most of its splits
empty and replayed from a graph, the streaming decode before the sink is
full, across the ring's wrap, with no sink, a tiny window and a wide one, and
replayed from a graph, the K/V pair writes (bf16 and INT4) and the streaming
write from strided rows, every route and tile boundary of the int8 matrix
product and its model shapes at M = 17 and 4096, the fused small-M linear
(quantization inside the kernel) at M = 1 to 8 for groups of one to three
weights, ragged widths, K = 14,336 and row-strided inputs, fewer blocks
than tiles and the longest K its ring takes, as one launch that a CUDA
graph replays, the engine's captured decode step against the
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
    (1, 1, 4, 4, 512, 511, 512),  # decode, G = 1, one split, the last slot
    (1, 1, 16, 4, 32768, 32767, 32768),  # decode, G = 4, every split full
    (1, 1, 16, 4, 16384, 16001, 16384),  # decode, an odd tail: the last tile holds two keys
    (3, 1, 16, 2, 8192, [5, 4096, 8191], 8192),  # decode, G = 8, B = 3, mixed lengths: empty splits
    (2, 1, 8, 2, 4096, [700, 4095], 0),  # decode, bucket 0: the plan comes from the buffer
    (1, 1, 12, 4, 1536, 0, 1536),  # decode, G = 3, one key in all: two of three splits empty
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
    decode split plan comes from the bucket): both wrappers are captured on a
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
@pytest.mark.parametrize("M", range(1, 9))
def test_w8a8_small_group_kernel_is_bitwise_the_plain_group(dev, M, group):
    """The fused small-M route (x quantized per row inside the kernel, every
    weight of the group in one launch) against the plain group (plain-torch
    quantization once, then w8a8_matmul_plain each), bitwise, at M = 1 to 8."""
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


@pytest.mark.parametrize("M", [1, 4, 8])
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
@pytest.mark.parametrize("M", [1, 8])
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


def test_w8a8_small_route_sizes_its_ring_beside_x(dev):
    """The kernel fits two ring stages beside 8 rows of x up to K = 23,808,
    bitwise the plain version there, and refuses the launch past it."""
    gen = torch.Generator(device=dev).manual_seed(70)
    x, weights = _small_group_inputs(gen, 8, (40,), 23808, torch.bfloat16, False)
    (got,) = quant.w8a8_linear_group(x, weights)
    (want,) = quant.w8a8_linear_group(x, weights, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x, weights = _small_group_inputs(gen, 8, (40,), 23824, torch.bfloat16, False)
    before = gemm.w8a8_matmul.small_launches
    with pytest.raises(RuntimeError):
        quant.w8a8_linear_group(x, weights)
    assert gemm.w8a8_matmul.small_launches == before


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
    with pytest.raises(ValueError):  # head_dim 64
        flash.full_cache_attention(randn(gen, 1, 4, 4, 64), randn(gen, 1, 2, 256, 64),
                                   randn(gen, 1, 2, 256, 64), 0)
    with pytest.raises(ValueError):  # not contiguous
        flash.full_cache_attention(randn(gen, 1, 4, 8, 128)[:, :, ::2], k, k, 0)
    with pytest.raises(ValueError):  # 16 query heads per KV head at decode
        flash.full_cache_attention(randn(gen, 1, 1, 16, 128), k[:, :1], k[:, :1], 0)
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
