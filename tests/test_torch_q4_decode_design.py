"""The design of the INT4 decode kernel, replayed on the CPU.

``csrc/flash_q4.cu::decode_q4_kernel`` is one launch over (key split, KV
head, sequence), by a plan made from the bucket. Each block's eight warps take
32 keys of every 256-key tile of the split and keep their own online softmax;
the block merges its warps once and writes a partial; the last block of a
(sequence, KV head) merges its at most 32 partials (only splits that hold
keys). Each pair row is read once: one 32-bit word of it feeds both keys'
nibbles to the tensor cores (``mma.sync`` m16n8k16, the channels and keys
renumbered so that fragments come straight from the words).

Here the plan's properties are tested; the fragment layout is replayed lane
by lane through a model of m16n8k16 (the swizzled ring, the word unpack, both
products), bit for bit where the kernel is exact; and the kernel's arithmetic
(per-warp softmax over its own keys, the in-block merge, the merge over the
splits that hold keys) is replayed in float32 and held to
``flash.kernel_tolerance_q4`` against ``full_cache_attention_q4_plain`` and
against the JAX package's ``full_cache_attention_q4`` (its Pallas decode
kernel in interpret mode), over several seeds.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.ops import flash as jflash
from duo_attention_tpu.ops import quant as jquant
from duo_attention_tpu_torch.ops import flash
from test_torch_q4_design import _bf16_bits_to_float, _byte_perm, _nibbles_to_bf16x2

torch.set_num_threads(1)
NEG = -0.7 * 3.402823466e38  # the kernels' NEG_INF
WARPS, TILE, D = 8, 256, 128  # the decode kernel's warps a block, keys a tile step, head_dim
SMS = 132  # an H100's SMs


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

SPANS = [1, 127, 128, 129, 512, 1000, 4096, 12288, 16384, 20000, 32768]
HEADS = [1, 2, 3, 4, 5, 6, 8, 12, 24]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("span", SPANS)
def test_q4_decode_split_plan(span, heads):
    nsplit, split_keys = flash.q4_decode_split_plan(span, heads)
    assert split_keys % flash.Q4_DECODE_TILE_KEYS == 0  # 128: a pair row never straddles two splits
    assert nsplit * split_keys >= span  # every key has a split
    assert (nsplit - 1) * split_keys < span  # and none starts past the span
    assert 1 <= nsplit <= flash.Q4_DECODE_ONE_MERGE  # one merge level
    assert nsplit * heads <= max(SMS, heads)  # one wave: one block an SM
    # as many splits as that allows, rounded to whole tiles
    tiles = -(-span // 128)
    wanted = max(1, min(SMS // heads, flash.Q4_DECODE_ONE_MERGE, tiles))
    assert nsplit == -(-tiles // -(-tiles // wanted))
    # a host function of the bucket and the pair count alone: nothing of the cache lengths
    assert list(inspect.signature(flash.q4_decode_split_plan).parameters) == ["span", "heads"]
    assert flash.q4_decode_split_plan(span, heads) == (nsplit, split_keys)


@pytest.mark.parametrize("span,B,hf,split_keys", [
    (16384, 1, 2, 512), (16384, 1, 4, 512), (16384, 1, 5, 640), (16384, 1, 6, 768), (32768, 1, 2, 1024),
    (16384, 4, 4, 2048), (16384, 12, 8, 16384)])
def test_q4_decode_split_plan_at_the_main_path(span, B, hf, split_keys):
    """The main path's layers (B = 1, 2-6 full KV heads, bucket 16384): 32
    splits of 512 keys a KV head up to 4 heads (one merge level), then one
    block an SM (130 and 132 blocks at 5 and 6 heads); at B = 4, 8 splits of
    2048; past 132 pairs, one split a pair."""
    nsplit, keys = flash.q4_decode_split_plan(span, B * hf)
    assert keys == split_keys and nsplit == -(-span // split_keys)


# ---------------------------------------------------------------------------
# The fragment layout, lane by lane
# ---------------------------------------------------------------------------


def _mma_16816(a_frag, b_frag):
    """mma.sync m16n8k16 from per-lane fragments (float64): a_frag[lane] =
    (a0, a1, a2, a3), b_frag[lane] = (b0, b1), each a (low, high) pair of
    values. Returns each lane's (c0, c1): row gid, columns 2t and 2t + 1."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a0, a1, a2, a3 = a_frag[lane]
        A[g, 2 * t : 2 * t + 2], A[g + 8, 2 * t : 2 * t + 2] = a0, a1
        A[g, 2 * t + 8 : 2 * t + 10], A[g + 8, 2 * t + 8 : 2 * t + 10] = a2, a3
        b0, b1 = b_frag[lane]
        Bm[2 * t : 2 * t + 2, g], Bm[2 * t + 8 : 2 * t + 10, g] = b0, b1
    C = A @ Bm
    return [(C[lane >> 2, 2 * (lane & 3)], C[lane >> 2, 2 * (lane & 3) + 1]) for lane in range(32)]


def _bf16x2_values(word):
    """A bf16x2 register (uint32) -> (low, high) float values."""
    w = np.uint32(word)
    return (float(_bf16_bits_to_float(np.array([w & 0xFFFF]))[0]),
            float(_bf16_bits_to_float(np.array([w >> 16]))[0]))


def _ring_stage(rows: np.ndarray) -> np.ndarray:
    """16 packed rows [16, 128] u8 as a warp's cp.async lays them in its
    stage: lane l, copy u: idx = l + 32u, row idx >> 3, piece c = idx & 7,
    stored at piece c ^ (row & 7)."""
    stage = np.zeros(16 * 128, np.uint8)
    for u in range(4):
        for lane in range(32):
            idx = lane + 32 * u
            r, c = idx >> 3, idx & 7
            dst = r * 128 + ((c ^ (r & 7)) << 4)
            stage[dst : dst + 16] = rows[r, 16 * c : 16 * c + 16]
    return stage


def _piece(stage, r, c):
    """The 16 bytes the kernel reads as logical piece c of row r (swizzled) -> 4 words."""
    off = r * 128 + ((c ^ (r & 7)) << 4)
    return [int(w) for w in stage[off : off + 16].view("<u4")]


def _unpack_word(w):
    """The kernel's unpack_word: (e01, e23, o01, o23) bf16x2 registers."""
    x = np.array([w], np.uint32)
    b01 = _byte_perm(x, np.zeros_like(x), 0x4140)
    b23 = _byte_perm(x, np.zeros_like(x), 0x4342)
    out = []
    for v in (b01, b23, b01 >> 4, b23 >> 4):
        lo, hi = _nibbles_to_bf16x2(v)
        out.append(int(lo[0]) | (int(hi[0]) << 16))
    return out


def _byte_to_bf16x2(w, i):
    """The kernel's byte_to_bf16x2<i>(w, w >> 4)."""
    x = np.array([w], np.uint32)
    lo, hi = _nibbles_to_bf16x2(_byte_perm(x, x >> 4, i | ((4 + i) << 8)))
    return int(lo[0]) | (int(hi[0]) << 16)


@pytest.mark.parametrize("grp", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fragments_give_both_products(seed, grp):
    """One warp's slice (16 pair rows, 32 keys) through the kernel's ring and
    fragments: S = q'.K of every key from one word per k-step (even and odd
    key from the same word), O = p'.V of all 16 keys of the group from one
    byte per (channel, pair row); both equal the direct sums exactly (the
    products of bf16 values are exact and float64 adds them here)."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (2, 16, 128), dtype=np.uint8)  # K, V: 16 pair rows of the slice
    stage_k, stage_v = _ring_stage(packed[0]), _ring_stage(packed[1])
    nib = np.stack([packed & 0xF, packed >> 4], axis=2).astype(np.float64)  # [K/V, pair row, token, D]
    G = 5  # rows 5-7 are zero, as for a group of 5 query heads
    qv = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32) * 4).bfloat16().float().numpy()
    qv[G:] = 0

    # S: lane (gid, t) feeds pair row 8 grp + gid, pieces 2t, 2t + 1 (channels 32t .. 32t + 31)
    S = {}
    for tok in (0, 1):
        acc = [(0.0, 0.0)] * 32
        for ks in range(8):
            a_frag, b_frag = [], []
            for lane in range(32):
                gid, t = lane >> 2, lane & 3
                r = 8 * grp + gid
                kw = _piece(stage_k, r, 2 * t) + _piece(stage_k, r, 2 * t + 1)
                e01, e23, o01, o23 = _unpack_word(kw[ks])
                b_frag.append((_bf16x2_values(e01 if tok == 0 else o01), _bf16x2_values(e23 if tok == 0 else o23)))
                ch = 32 * t + 4 * ks
                a_frag.append(((qv[gid, ch], qv[gid, ch + 1]), (0.0, 0.0), (qv[gid, ch + 2], qv[gid, ch + 3]), (0.0, 0.0)))
            c = _mma_16816(a_frag, b_frag)
            acc = [(x0 + y0, x1 + y1) for (x0, x1), (y0, y1) in zip(acc, c)]
        S[tok] = acc
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        for c in (0, 1):
            pr = 8 * grp + 2 * t + c  # the C fragment's column 2t + c is the group's pair row 2t + c
            for tok in (0, 1):
                assert S[tok][lane][c] == pytest.approx(float(qv[gid] @ nib[0, pr, tok]), rel=1e-12, abs=1e-9)

    # O: p' of row gid for the group's keys, A from each lane's own scores
    pv = torch.from_numpy(rng.random((8, 16, 2)).astype(np.float32)).bfloat16().float().numpy()  # [row, pair row, token]
    for j in range(16):  # n-tile j: channel 16 gid + j of the B fragment
        a_frag, b_frag = [], []
        for lane in range(32):
            gid, t = lane >> 2, lane & 3
            ra, rb = 8 * grp + 2 * t, 8 * grp + 2 * t + 1
            a_frag.append(((pv[gid, ra, 0], pv[gid, ra, 1]), (0.0, 0.0), (pv[gid, rb, 0], pv[gid, rb, 1]), (0.0, 0.0)))
            wa, wb = _piece(stage_v, ra, gid)[j // 4], _piece(stage_v, rb, gid)[j // 4]
            b_frag.append((_bf16x2_values(_byte_to_bf16x2(wa, j % 4)), _bf16x2_values(_byte_to_bf16x2(wb, j % 4))))
        c = _mma_16816(a_frag, b_frag)
        for lane in range(32):
            gid, t = lane >> 2, lane & 3
            keys = slice(8 * grp, 8 * grp + 8)
            for h in (0, 1):  # c0: channel 32t + j, c1: channel 32t + 16 + j
                ch = 32 * t + 16 * h + j
                want = float((pv[gid, keys] * nib[1, keys, :, ch]).sum())
                assert c[lane][h] == pytest.approx(want, rel=1e-12, abs=1e-9)


def test_byte_to_bf16x2_is_exact_for_every_byte():
    """The P.V operand: byte i of a word becomes (low nibble, high nibble) as
    bf16, bit for bit, for all 256 values in every byte position."""
    for i in range(4):
        for v in range(256):
            w = (v << (8 * i)) | (0xA5 << (8 * ((i + 1) % 4)))  # a neighbour byte that must not leak in
            lo, hi = _bf16x2_values(_byte_to_bf16x2(w, i))
            assert (lo, hi) == (float(v & 0xF), float(v >> 4))


# ---------------------------------------------------------------------------
# The arithmetic: warps, the block's merge, the splits' merge
# ---------------------------------------------------------------------------


def _planes(packed, s4):
    """[T2, D] u8 and [4, T2] bf16 -> nibbles [T, D], scale [T], zero-point [T] (float32)."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=1).flatten(0, 1).float()
    sc = torch.stack([s4[0], s4[1]], dim=-1).flatten().float()
    zp = torch.stack([s4[2], s4[3]], dim=-1).flatten().float()
    return nib, sc, zp


def _block_partial(qf, qsum, kplanes, vplanes, lo, hi):
    """One block (split [lo, hi)): each warp's online softmax over its own
    keys (32 of every 256-key tile), p * vscale rounded to bf16, then the
    block's merge of its warps. Returns (acc [G, D], m, l, z [G])."""
    (knib, ksc, kzp), (vnib, vsc, vzp) = kplanes, vplanes
    G = qf.shape[0]
    states = []
    for w in range(WARPS):
        m, l, z, acc = torch.full((G,), NEG), torch.zeros(G), torch.zeros(G), torch.zeros(G, D)
        for key0 in range(lo + 32 * w, hi, TILE):
            keys = torch.arange(key0, min(key0 + 32, hi))
            s = (qf @ knib[keys].T) * ksc[keys] + qsum[:, None] * kzp[keys]
            m_next = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next[:, None])
            l = alpha * l + p.sum(-1)
            z = alpha * z + (p * vzp[keys]).sum(-1)
            acc = alpha[:, None] * acc + (p * vsc[keys]).bfloat16().float() @ vnib[keys]
            m = m_next
        states.append((m, l, z, acc))
    M = torch.stack([st[0] for st in states]).amax(0)
    f = [torch.where(st[0] == NEG, torch.zeros(G), torch.exp(st[0] - M)) for st in states]
    return (sum(fw[:, None] * st[3] for fw, st in zip(f, states)), M,
            sum(fw * st[1] for fw, st in zip(f, states)), sum(fw * st[2] for fw, st in zip(f, states)))


def _merge(parts):
    """merge_partials: (acc [G, D], m, l, z) states -> (sum_s w_s (acc_s + z_s),
    M, sum_s w_s l_s) with w_s = e^(m_s - M); a left-out split has m = NEG
    and weighs 0."""
    M = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.where(p[1] == NEG, torch.zeros_like(M), torch.exp(p[1] - M)) for p in parts]
    return (sum(ws[:, None] * (p[0] + p[3][:, None]) for ws, p in zip(w, parts)), M,
            sum(ws * p[2] for ws, p in zip(w, parts)))


def _kernel_replay(q, kq, ks4, vq, vs4, cs, span, drop=None):
    """decode_q4_kernel's arithmetic in float32. q [B, 1, Hq, D] bf16; packed
    [B, Hkv, T2, D] u8; scales [B, Hkv, 4, T2] bf16; cs [B] ints. ``drop``
    leaves one split out of the merge. Returns ([B, 1, Hq, D] bf16, the splits
    that held keys per (b, KV head), nsplit)."""
    B, _, Hq, _ = q.shape
    Hkv = kq.shape[1]
    G = Hq // Hkv
    nsplit, split_keys = flash.q4_decode_split_plan(span, B * Hkv)
    scale = float(torch.tensor(D**-0.5, dtype=torch.bfloat16))
    out = torch.zeros(B, 1, Hq, D, dtype=torch.bfloat16)
    valid = []
    for b in range(B):
        kend = min(span, int(cs[b]) + 1)
        nvalid = min(nsplit, -(-kend // split_keys))
        assert nvalid * split_keys >= kend and (nvalid - 1) * split_keys < kend  # the rest are empty
        for hk in range(Hkv):
            qf = (q[b, 0, hk * G : (hk + 1) * G] * scale).float()  # the scale folded into q in bf16
            qsum = qf.sum(-1)
            kp, vp = _planes(kq[b, hk], ks4[b, hk]), _planes(vq[b, hk], vs4[b, hk])
            parts = [_block_partial(qf, qsum, kp, vp, s * split_keys, min(kend, (s + 1) * split_keys))
                     for s in range(nvalid)]
            if drop is not None:
                parts[drop] = (parts[drop][0], torch.full((G,), NEG), torch.zeros(G), torch.zeros(G))
            assert nvalid <= 32  # one merge: a lane for each partial
            o, _, den = _merge(parts)
            out[b, 0, hk * G : (hk + 1) * G] = (o / torch.where(den == 0, 1.0, den)[:, None]).bfloat16()
            valid.append(nvalid)
    return out, valid, nsplit


def _inputs(seed, B, Hq, Hkv, T, q_mul=4.0):
    """q drawn ``q_mul`` times larger than k (4: peaked scores, as on the
    card); K and V quantized by the JAX package, the same bytes for both
    packages."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D)).astype(np.float32) * q_mul).bfloat16()
    kq, ks4 = jquant.quantize_int4_paired(jnp.asarray(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)))
    vq, vs4 = jquant.quantize_int4_paired(jnp.asarray(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)))
    port = [torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(ks4.astype(jnp.float32))).bfloat16(),
            torch.from_numpy(np.array(vq)), torch.from_numpy(np.array(vs4.astype(jnp.float32))).bfloat16()]
    return q, port, (kq, ks4, vq, vs4)


def _within(got, want):
    err = (got.float() - want.float()).abs()
    return bool((err <= flash.kernel_tolerance_q4(want)).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,Hq,Hkv,T,cs,bucket", [
    (1, 8, 2, 2048, 1500, 2048),  # 16 one-tile splits, the last few empty
    (1, 8, 2, 2048, 1001, 2048),  # an odd frontier: the last pair row holds one visible key
    (1, 16, 2, 4096, 200, 4096),  # G = 8, a short sequence in a long bucket: 30 of 32 splits empty
    (2, 4, 4, 1024, [1023, 60], 1024),  # G = 1, [B] lengths, a span below one tile's worth of keys in b = 1
    (1, 12, 4, 512, 77, 0),  # G = 3, bucket 0 (the whole buffer): one tile a split, 3 of 4 empty
])
def test_decode_replay_matches_plain_and_jax(seed, B, Hq, Hkv, T, cs, bucket):
    """Against the plain version with peaked queries (4x, as the card's tests
    draw them) and with unit ones; against the JAX kernel with unit ones, as
    the JAX package's own tests draw them: its decode mode requantizes q and
    p to int8, which with 4x queries moves it from exact attention by up to
    2.4 kernel_tolerance_q4 by itself (0.63 at most with unit queries)."""
    cs_np = np.broadcast_to(np.asarray(cs, np.int32).reshape(-1), (B,)).copy()
    span = T if bucket == 0 else min(bucket, T)
    for q_mul in (4.0, 1.0):
        q, port, jargs = _inputs(seed, B, Hq, Hkv, T, q_mul)
        got, valid, nsplit = _kernel_replay(q, *port, cs_np, span)
        assert min(valid) < nsplit  # the cases reach empty splits
        plain = flash.full_cache_attention_q4_plain(q, *port, torch.from_numpy(cs_np), bucket=bucket)
        assert _within(got, plain)
    kq, ks4, vq, vs4 = jargs
    pallas = jflash.full_cache_attention_q4(
        jnp.asarray(q.float().numpy()), kq, jquant.paired_scales_to_cache_layout(ks4), vq,
        jquant.paired_scales_to_cache_layout(vs4), jnp.asarray(cs_np), bucket=bucket)
    assert _within(got, torch.from_numpy(np.array(pallas, np.float32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_replay_rejects_the_heaviest_split_left_out(seed):
    """With peaked scores the bound catches a merge that loses the split that
    carries the most weight."""
    q, port, _ = _inputs(seed, 1, 8, 2, 2048)
    cs = np.array([1999], np.int32)
    plain = flash.full_cache_attention_q4_plain(q, *port, torch.from_numpy(cs), bucket=2048)
    nsplit, split_keys = flash.q4_decode_split_plan(2048, 2)
    # the split holding the largest score of head 0
    kp = _planes(port[0][0, 0], port[1][0, 0])
    qf = (q[0, 0, :4] * float(torch.tensor(D**-0.5, dtype=torch.bfloat16))).float()
    s = (qf @ kp[0].T) * kp[1] + qf.sum(-1, keepdim=True) * kp[2]
    heavy = int(s[:, : cs[0] + 1].amax(0).argmax()) // split_keys
    got, _, _ = _kernel_replay(q, *port, cs, 2048, drop=heavy)
    assert not _within(got, plain)
