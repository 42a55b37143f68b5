"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a GPU and nvcc; elsewhere they skip. On a machine with a card
(which need not have jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

chip_smoke.py holds the kernels to the plain versions at the main path's
shapes; these cover the shapes it does not reach: ragged query tiles, query
groups of 1, 2 and 8, no sink, small rings that wrap, per-sequence lengths,
and the wrappers' refusals.
"""

import pytest
import torch

from duo_attention_tpu_torch.ops import flash, inplace

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


@pytest.mark.parametrize("pos", [0, 511, 600, [3, 0, 511], [-4, 1000, 17]])
def test_write_row_kernel(dev, pos):
    gen = torch.Generator(device=dev).manual_seed(2)
    buf, row = randn(gen, 3, 2, 512, 128), randn(gen, 3, 2, 1, 128)
    ref = buf.clone()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    inplace.write_row(buf, row, pos)
    inplace.write_row_plain(ref, row, pos)
    assert torch.equal(buf, ref)


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
