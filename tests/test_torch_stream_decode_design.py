"""The design of the streaming decode kernel and of the INT4 pair write,
replayed on the CPU.

``csrc/flash.cu::stream_decode_kernel`` splits the at most sink + recent + 1
keys a (sequence, streaming KV head) sees over blocks by a plan made from the
window alone, and a block's keys over its warps, 16 keys a warp at a time:
each warp runs the online softmax over its keys (p rounded to bf16 against
the warp's running max, float32 sums), the block merges its warps, and the
leader of the (sequence, head)'s thread-block cluster merges the splits in
the same launch. Here the plan function itself is tested, and
that arithmetic is replayed in plain torch and held to
``flash.kernel_tolerance`` against ``streaming_cache_attention_plain``: the
bound the kernel is held to on the card. The INT4 decode write's pair form
(K and V rows in one call, read in place from strided views) is held bitwise
to two calls of the JAX package's ``cache.write_full_q4``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch.ops import flash
from test_torch_quant import _kv_like, _q4_buffers, _to_jax_scales8, bits, jax_scales4, jbits, t

torch.set_num_threads(1)
NEG = -0.7 * 3.402823466e38  # the kernels' NEG_INF
TILE = flash.STREAM_DECODE_TILE_KEYS


def _visible_keys(k_sink, v_sink, k_ring, v_ring, cs, sink, recent):
    """The keys of one sequence's decode query at position cs, in the kernel's
    walk order (the sink slots, then the ring in position order): K and V
    [Hs, n, D] float32, as ``key_range`` and ``kv_row`` of csrc/flash.cu find
    them (total = cs + 1 tokens)."""
    R = k_ring.shape[1]
    t_ = cs + 1
    glo = max(sink, cs - recent, 0, t_ - R)
    end = sink + max(min(t_ - 1, cs) - glo + 1, 0)
    if cs < sink:
        end = min(end, cs + 1)
    slots_ring = [(glo + j - sink) % R for j in range(sink, end)]
    k = torch.cat([k_sink[:, : min(end, sink)], k_ring[:, slots_ring]], dim=1)
    v = torch.cat([v_sink[:, : min(end, sink)], v_ring[:, slots_ring]], dim=1)
    return k.float(), v.float()


def _kernel_states(q, k, v, nsplit, split_keys):
    """Each split's merged state, as a block of the kernel leaves it: q [Hq, D]
    bf16; k/v [Hs, n, D] float32 visible keys. Returns acc [nsplit, Hq, D], m
    and l [nsplit, Hq]; a split past the frontier stays at (0, NEG, 0)."""
    Hq, D = q.shape
    G = Hq // k.shape[0]
    n = k.shape[1]
    scale = float(torch.tensor(D**-0.5, dtype=torch.bfloat16))
    qf = (q * scale).float()  # the scale folded into q in bf16
    kf, vf = k.repeat_interleave(G, dim=0), v.repeat_interleave(G, dim=0)
    warps = min(flash.STREAM_DECODE_MAX_WARPS, split_keys // TILE)
    wkeys = TILE * -(-(split_keys // TILE) // warps)
    acc, m, l = torch.zeros(nsplit, Hq, D), torch.full((nsplit, Hq), NEG), torch.zeros(nsplit, Hq)
    for s in range(nsplit):
        lo, hi = s * split_keys, min(n, (s + 1) * split_keys)
        warp_states = []
        for w in range(warps):
            wlo, whi = lo + w * wkeys, min(hi, lo + (w + 1) * wkeys)
            if wlo >= whi:
                continue
            wacc, wm, wl = torch.zeros(Hq, D), torch.full((Hq,), NEG), torch.zeros(Hq)
            for k0 in range(wlo, whi, TILE):  # the warp's tiles, one online-softmax step each
                k1 = min(k0 + TILE, whi)
                sc = torch.einsum("hd,htd->ht", qf, kf[:, k0:k1])
                m_next = torch.maximum(wm, sc.amax(-1))
                alpha = torch.exp(wm - m_next)
                p = torch.exp(sc - m_next[:, None])
                wl = alpha * wl + p.sum(-1)
                # p rounded to bf16 against the warp's running max, then P.V in float32
                wacc = alpha[:, None] * wacc + torch.einsum("ht,htd->hd", p.bfloat16().float(), vf[:, k0:k1])
                wm = m_next
            warp_states.append((wacc, wm, wl))
        if warp_states:  # the block's merge of its warps
            wa, wm, wl = (torch.stack(x) for x in zip(*warp_states))
            M = wm.amax(0)
            f = torch.exp(wm - M)
            acc[s], m[s], l[s] = (f[..., None] * wa).sum(0), M, (f * wl).sum(0)
    return acc, m, l


def _merge(acc, m, l, keep=None):
    """The splits' merge: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s."""
    if keep is not None:
        acc, m, l = acc[keep], m[keep], l[keep]
    M = m.amax(0)
    w = torch.exp(m - M)
    den = (w * l).sum(0)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return ((w[..., None] * acc).sum(0) / den[:, None]).bfloat16()


def _inputs(B, Hs, G, sink, R, seed=5, chunk=256):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, 1, Hs * G, 128, generator=gen) * 4.0).bfloat16()  # peaked, as on the card
    k_sink, v_sink = (torch.randn(B, Hs, sink + chunk, 128, generator=gen).bfloat16() for _ in range(2))
    k_ring, v_ring = (torch.randn(B, Hs, R, 128, generator=gen).bfloat16() for _ in range(2))
    return q, k_sink, v_sink, k_ring, v_ring


def _within(got, plain):
    return bool(((got.float() - plain.float()).abs() <= flash.kernel_tolerance(plain)).all())


def _replay(q, bufs, cs, sink, recent):
    """The kernel's output for every sequence (cs a list of positions), and
    each sequence's split states."""
    B, Hs = q.shape[0], bufs[0].shape[1]
    nsplit, split_keys = flash.stream_decode_split_plan(sink, recent, B * Hs)
    outs, states = [], []
    for b in range(B):
        k, v = _visible_keys(*(x[b] for x in bufs), cs[b], sink, recent)
        st = _kernel_states(q[b, 0], k, v, nsplit, split_keys)
        outs.append(_merge(*st))
        states.append((st, k.shape[1]))
    return torch.stack(outs)[:, None], states, split_keys


@pytest.mark.parametrize("B,Hs,G,sink,recent,R,cs", [
    (1, 2, 4, 64, 256, 4608, [16000]),  # the main path's window: 6 splits of 64 keys, 4 warps each
    (1, 2, 4, 64, 256, 4608, [10]),  # cs < sink: 11 keys, 5 splits empty
    (1, 2, 4, 64, 256, 512, [600]),  # tokens 344..600 cross ring slot R = 512
    (4, 1, 4, 64, 256, 4608, [5, 64, 4700, 32000]),  # mixed lengths at B = 4
    (1, 4, 1, 64, 256, 4608, [16000]),  # G = 1
    (1, 1, 8, 64, 256, 4608, [16000]),  # G = 8
    (1, 1, 4, 0, 256, 4608, [3000]),  # no sink
    (2, 1, 4, 64, 8, 128, [100, 16000]),  # a tiny window: one split
    (1, 1, 4, 128, 2048, 4608, [16000]),  # a wide window: two tiles for some warps
])
def test_stream_decode_replay_within_kernel_tolerance(B, Hs, G, sink, recent, R, cs):
    q, *bufs = _inputs(B, Hs, G, sink, R)
    got, states, split_keys = _replay(q, bufs, cs, sink, recent)
    cs_t = torch.tensor(cs)
    plain = flash.streaming_cache_attention_plain(q, *bufs, cs_t, cs_t + 1, sink, recent)
    assert _within(got, plain)
    for (acc, m, l), n in states:
        # splits past the frontier stay empty and weigh nothing
        first_empty = -(-n // split_keys)
        assert bool((l[first_empty:] == 0).all()) and bool((m[first_empty:] == NEG).all())
        assert torch.equal(_merge(acc, m, l), _merge(acc, m, l, keep=slice(0, first_empty)))


@pytest.mark.parametrize("rank", [0, 1])
def test_stream_decode_replay_rejects_a_split_left_out(rank):
    """With peaked scores the bound catches a merge that loses one of the 6
    splits of the main path's window: the split that weighs most in some
    head's row, and the next."""
    sink, recent, cs = 64, 256, 16000
    q, *bufs = _inputs(1, 2, 4, sink, 4608, seed=7)
    _, states, _ = _replay(q, bufs, [cs], sink, recent)
    (acc, m, l), _ = states[0]
    plain = flash.streaming_cache_attention_plain(q, *bufs, cs, cs + 1, sink, recent)
    share = torch.exp(m - m.amax(0)) * l
    share = share / share.sum(0)
    drop = int(share.amax(1).argsort(descending=True)[rank])
    assert float(share[drop].max()) > 2.0**-5, "the dropped split carries too little to show"
    keep = [s for s in range(acc.shape[0]) if s != drop]
    assert not _within(_merge(acc, m, l, keep=keep)[None, None], plain)


def test_no_visible_key_gives_zero():
    """Every split empty: M = NEG_INF, all weights 1, all sums 0, and the row
    is 0, as the kernel's l == 0 -> 1."""
    acc, m, l = torch.zeros(6, 4, 128), torch.full((6, 4), NEG), torch.zeros(6, 4)
    out = _merge(acc, m, l)
    assert bool(torch.isfinite(out.float()).all()) and bool((out == 0).all())


WINDOWS = [(64, 256), (0, 256), (64, 8), (8, 16), (128, 256), (0, 0), (128, 2048), (64, 1024)]
HEADS = [1, 2, 3, 4, 6, 16, 24, 48, 132, 264]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("sink,recent", WINDOWS)
def test_stream_decode_split_plan(sink, recent, heads):
    nsplit, split_keys = flash.stream_decode_split_plan(sink, recent, heads)
    keys = sink + recent + 1
    assert nsplit * split_keys >= keys  # every visible key has a split
    assert (nsplit - 1) * split_keys < keys  # and the plan leaves no split empty
    assert split_keys % TILE == 0
    assert 1 <= nsplit <= flash.STREAM_DECODE_MAX_SPLITS  # a cluster's blocks (the portable size)
    assert nsplit * heads <= max(flash.STREAM_DECODE_WAVE_BLOCKS, heads)  # one wave where it can
    if (sink, recent) == (64, 256) and heads <= 24:
        # the main path's window and head counts (2-6 a layer, B up to 4): one tile a warp
        assert split_keys // TILE <= flash.STREAM_DECODE_MAX_WARPS
        assert nsplit >= 5 and split_keys // TILE <= flash.STREAM_DECODE_SPLIT_TILES + 1
    # a host function of the window and the head count alone: nothing of the cache lengths
    assert list(inspect.signature(flash.stream_decode_split_plan).parameters) == ["sink", "recent", "heads"]
    assert flash.stream_decode_split_plan(sink, recent, heads) == (nsplit, split_keys)


@pytest.mark.parametrize("start", [4, 5, 126, 127, 500, [0, 7, 126], [9, 9, 300], [-3, 64, 65]])
def test_write_q4_token_pair_matches_two_jax_writes(start):
    """The INT4 decode write's pair form (plain version, K and V rows read from
    ``transpose`` views of [B, 1, Hkv, D] projections, as the decode step
    hands them) against two calls of JAX's ``write_full_q4``, bitwise: every
    packed byte and every bf16 scale of both buffers."""
    B, H, Hkv, T, D = 3, 2, 4, 128, 32
    seed = 11 + int(np.sum(start))
    (kq, ks4), (vq, vs4) = _q4_buffers(seed, B, H, T, D), _q4_buffers(seed + 1, B, H, T, D)
    # [B, 1, Hkv, D]: K rows of varied ranges, V rows on rounding ties
    k_proj = _kv_like(seed + 2, B, Hkv, 3, D)[:, :, 2:3].transpose(0, 2, 1, 3)
    v_proj = _kv_like(seed + 3, B, Hkv, 3, D)[:, :, 1:2].transpose(0, 2, 1, 3)
    k_in, v_in = np.ascontiguousarray(k_proj[:, :, :H].transpose(0, 2, 1, 3)), \
        np.ascontiguousarray(v_proj[:, :, :H].transpose(0, 2, 1, 3))  # [B, H, 1, D]
    st = np.asarray(start, np.int32)
    jkq, jks8 = jcache.write_full_q4(jnp.asarray(kq), _to_jax_scales8(ks4), jnp.asarray(k_in), jnp.asarray(st))
    jvq, jvs8 = jcache.write_full_q4(jnp.asarray(vq), _to_jax_scales8(vs4), jnp.asarray(v_in), jnp.asarray(st))
    bufs = [t(kq), ks4.clone(), t(vq), vs4.clone()]
    k_row = t(k_proj)[:, :, :H].transpose(1, 2)  # views: [B, H, 1, D], not contiguous
    v_row = t(v_proj)[:, :, :H].transpose(1, 2)
    assert not k_row.is_contiguous()
    got = tcache.write_full_q4_pair(*bufs, k_row, v_row, t(st))
    assert all(g is b for g, b in zip(got, bufs))  # mutated in place
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jvq))
    np.testing.assert_array_equal(bits(got[1]), jbits(jax_scales4(jks8, H)))
    np.testing.assert_array_equal(bits(got[3]), jbits(jax_scales4(jvs8, H)))
    assert not np.array_equal(got[0].numpy(), kq) and not np.array_equal(got[2].numpy(), vq)
