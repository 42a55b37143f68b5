"""The port's split KV cache against the JAX package's, on the CPU: sizing,
initial buffers, chunk and single-token writes (exact), and the visible set
the masks present after a sequence of writes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu.config import DuoConfig as JDuoConfig
from duo_attention_tpu.config import TINY_GQA as J_TINY_GQA
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch.config import TINY_GQA, DuoConfig

# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)


def duo_pair(**kw):
    return DuoConfig(**kw), JDuoConfig(**kw)


SPLIT = dict(sink_size=4, recent_size=8, num_full_kv_heads=(0, 2, 4), max_cache_size=256,
             prefill_chunk_size=16)


@pytest.mark.parametrize("decode_only", [False, True])
@pytest.mark.parametrize("sink,recent,chunk", [(64, 256, 4096), (4, 8, 16), (0, 1000, 8192)])
def test_sizes_match_jax(decode_only, sink, recent, chunk):
    tduo, jduo = duo_pair(sink_size=sink, recent_size=recent, prefill_chunk_size=chunk)
    assert tcache.ring_capacity(tduo, decode_only) == jcache.ring_capacity(jduo, decode_only)
    assert tcache.sink_rows(tduo, decode_only) == jcache.sink_rows(jduo, decode_only)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_only", [False, True])
def test_init_cache_shapes_and_bytes_match_jax(dtype, decode_only):
    tduo, jduo = duo_pair(**SPLIT)
    tc = tcache.init_cache(TINY_GQA, tduo, 2, getattr(torch, dtype), "cpu", decode_only)
    jc = jcache.init_cache(J_TINY_GQA, jduo, 2, getattr(jnp, dtype), decode_only)
    for name in tcache.DuoCache.BUFFERS:
        got = [tuple(b.shape) for b in getattr(tc, name)]
        assert got == [tuple(b.shape) for b in getattr(jc, name)], name
        assert all(not b.any() for b in getattr(tc, name))
    assert tc.length.dtype == torch.int32 and tc.length.dim() == 0 and int(tc.length) == 0
    assert tcache.kv_memory_bytes(tc) == jcache.kv_memory_bytes(jc)


def test_init_cache_rejects_unaligned_size():
    tduo, _ = duo_pair(**dict(SPLIT, max_cache_size=200))
    with pytest.raises(ValueError, match="multiple of 128"):
        tcache.init_cache(TINY_GQA, tduo, 1, torch.float32, "cpu")


@pytest.mark.parametrize("S,start", [(16, 0), (16, 32), (160, 320), (1, 5), (1, 383), (1, 400)])
def test_write_full_matches_jax(S, start):
    """Chunk writes clamp their start into [0, T - S] like JAX's
    dynamic_update_slice (T = 384 is not a multiple of the 160-token chunk);
    single-token writes clamp into [0, T - 1]."""
    rng = np.random.default_rng(S + start)
    buf = rng.standard_normal((2, 3, 384, 8)).astype(np.float32)
    inc = rng.standard_normal((2, 3, S, 8)).astype(np.float32)
    want = np.asarray(jcache.write_full(jnp.asarray(buf), jnp.asarray(inc), jnp.asarray(start, jnp.int32)))
    tb = torch.from_numpy(buf.copy())
    got = tcache.write_full(tb, torch.from_numpy(inc), start)
    assert got is tb
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,start", [(16, 0), (16, 16), (16, 48), (16, 500), (1, 2), (1, 9), (1, 77)])
def test_write_streaming_matches_jax(S, start):
    rng = np.random.default_rng(S * 1000 + start)
    sink, chunk, R = 4, 16, 32
    bufs = [rng.standard_normal(shape).astype(np.float32)
            for shape in [(2, 2, sink + chunk, 8)] * 2 + [(2, 2, R, 8)] * 2]
    kn, vn = (rng.standard_normal((2, 2, S, 8)).astype(np.float32) for _ in range(2))
    want = jcache.write_streaming(*map(jnp.asarray, bufs), jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(start, jnp.int32), sink)
    tbufs = [torch.from_numpy(b.copy()) for b in bufs]
    got = tcache.write_streaming(*tbufs, torch.from_numpy(kn), torch.from_numpy(vn), start, sink)
    for g, w, tb in zip(got, want, tbufs):
        assert g is tb
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _expected_visible(qpos, chunk_start, sink, recent):
    vis = set(range(min(sink, qpos + 1)))
    return vis | set(range(max(chunk_start - recent, 0), qpos + 1))


@pytest.mark.parametrize("chunks,sink,recent,cap", [
    ([8, 8, 3], 4, 8, 8),  # padded tail chunk stays invisible
    ([8, 8, 5] + [1] * 20, 4, 8, 8),  # decode after prefill
    ([8, 8, 1, 1, 1], 0, 4, 8),  # no sink
])
def test_visible_set_after_writes(chunks, sink, recent, cap):
    """Feed position-encoded tokens through write_streaming; after each chunk
    every query must see exactly sink ∪ window-as-of-chunk-start ∪ causal
    incoming (the counterpart of tests/test_cache.py::run_sim)."""
    B, H, D = 1, 1, 4
    R = recent + cap
    k_sink, v_sink = torch.zeros(B, H, sink + cap, D), torch.zeros(B, H, sink + cap, D)
    k_ring, v_ring = torch.zeros(B, H, R, D), torch.zeros(B, H, R, D)
    total = 0
    for n in chunks:
        S = 1 if n == 1 else cap
        vals = torch.zeros(B, H, S, D)
        vals[0, 0, :, 0] = torch.where(torch.arange(S) < n, torch.arange(total, total + S), -999)
        tcache.write_streaming(k_sink, v_sink, k_ring, v_ring, vals, vals.clone(), total, sink)
        cs, total = total, total + n
        qpos = torch.arange(cs, cs + S)
        m_sink = tcache.sink_mask(qpos, sink, sink)
        m_ring = tcache.ring_mask(qpos, R, cs + S, cs, sink, recent)
        for qi in range(n):
            visible = {int(k_sink[0, 0, s, 0]) for s in range(sink) if m_sink[qi, s]}
            visible |= {int(k_ring[0, 0, s, 0]) for s in range(R) if m_ring[qi, s]}
            assert visible == _expected_visible(cs + qi, cs, sink, recent)
