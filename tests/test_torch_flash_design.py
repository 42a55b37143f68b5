"""The design of the bf16 decode kernel, replayed on the CPU.

The CUDA kernel of ``csrc/flash.cu`` lays the keys every (sequence, KV
head) reads end to end in 128-key tiles and gives each block of a fixed grid
an equal share of them; each block works out its share on the device from
the lengths (``flash.decode_partition`` mirrors it on the host). A block's
warps take 16-key chunks in turn, each with its own online softmax, and the
block writes one partial a (sequence, KV head) its share touches; the merge
finds those blocks again (``flash.decode_merge_blocks``) and combines them.
Here the partition itself is tested, and the kernel's arithmetic is
replayed in plain torch (per-chunk online softmax in each warp, p rounded to
bf16 against the warp's running max, the block's merge of its warps, float32
partials, the merge) and held to ``flash.kernel_tolerance`` against
``full_cache_attention_plain``: the bound the kernel is held to on the card.
"""

import inspect

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import flash

torch.set_num_threads(1)
NEG = -0.7 * 3.402823466e38  # the kernels' NEG_INF
TILE, CHUNK, WARPS = flash.DECODE_TILE_KEYS, flash.DECODE_CHUNK_KEYS, flash.DECODE_WARPS
H100_SMS = 132


def _pool_lengths(B, seed, bucket, live_share=0.4):
    """A serving pool's rows: about ``live_share`` of them live at lengths
    below the bucket, the rest freed at stale lengths (some past the bucket),
    as (cs, valid)."""
    rng = np.random.default_rng(seed)
    live = rng.random(B) < live_share
    live[rng.integers(B)] = True
    cs = np.where(live, rng.integers(0, bucket, B), rng.integers(0, 3 * bucket, B))
    return cs.tolist(), live.astype(int).tolist()


def _row_keys_of(kind, B, seed):
    """(row keys, span) of a scenario: a pool with freed rows, every row
    live, or rows of a few keys."""
    if kind == "pool":
        cs, valid = _pool_lengths(B, seed, 32768)
        return flash.decode_row_keys(cs, valid, 32768), 32768
    rng = np.random.default_rng(seed)
    if kind == "live":
        return flash.decode_row_keys(rng.integers(0, 8192, B).tolist(), None, 8192), 8192
    return flash.decode_row_keys(rng.integers(0, 300, B).tolist(), None, 512), 512


@pytest.mark.parametrize("kind", ["pool", "live", "tiny"])
@pytest.mark.parametrize("hf", range(1, 9))
@pytest.mark.parametrize("B", [1, 2, 5, 8, 16])
def test_decode_partition(B, hf, kind):
    row_keys, span = _row_keys_of(kind, B, seed=100 * B + hf)
    nblocks = flash.decode_grid(B, hf, span, H100_SMS)
    blocks = flash.decode_partition(row_keys, hf, nblocks)
    assert len(blocks) == nblocks
    seen = {(b, hk): np.zeros(row_keys[b], np.int64) for b in range(B) for hk in range(hf)}
    tiles, slots = [], set()
    for p, segs in enumerate(blocks):
        n = 0
        for b, hk, lo, hi in segs:
            assert 0 <= lo < hi <= row_keys[b] and lo % TILE == 0
            seen[(b, hk)][lo:hi] += 1
            n += -(-(hi - lo) // TILE)
            slot = p + b * hf + hk  # the block's partial for the pair: never shared with another
            assert slot not in slots and slot < nblocks + B * hf
            slots.add(slot)
        tiles.append(n)
    # every key of every (row, head) lies in exactly one block's share; a row with no query has none
    assert all(bool((c == 1).all()) for c in seen.values())
    assert all(not any(s[0] == b for segs in blocks for s in segs) for b in range(B) if row_keys[b] == 0)
    # the shares differ by at most one tile, and none is empty while there are tiles to spare
    total = hf * sum(-(-n // TILE) for n in row_keys)
    used = [t for t in tiles if t]
    assert sum(tiles) == total and len(used) == min(nblocks, total)
    assert not used or max(used) - min(used) <= 1
    assert tiles[:len(used)] == used  # the empty blocks are the last ones
    # the merge finds, for each pair, exactly the blocks that touched it, in block order
    for b in range(B):
        for hk in range(hf):
            touched = [p for p, segs in enumerate(blocks) if any(s[:2] == (b, hk) for s in segs)]
            assert list(flash.decode_merge_blocks(row_keys, hf, nblocks, b, hk)) == touched


@pytest.mark.parametrize("span", [1, 127, 128, 129, 4096, 32768])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (1, 4), (16, 1), (16, 8)])
def test_decode_grid(B, Hkv, span):
    """Two blocks an SM, or the tiles the bucket leaves when fewer; made from
    host integers alone, nothing of the lengths on the device."""
    n = flash.decode_grid(B, Hkv, span, H100_SMS)
    assert n == min(flash.DECODE_BLOCKS_PER_SM * H100_SMS, B * Hkv * -(-span // TILE))
    assert list(inspect.signature(flash.decode_grid).parameters) == ["B", "Hkv", "span", "sms"]


def _segment_state(qf, kf, vf, lo, hi):
    """One block's partial over keys [lo, hi) of one (sequence, KV head), as
    the kernel computes it. qf [G, D] float32 (q scaled in bf16), kf/vf [T, D]
    float32. Warp w takes chunks w, w + 4, ... of 16 keys; each chunk's scores
    update the warp's running max m, p = e^(s - m) is rounded to bf16 for
    P.V, and l sums the unrounded p. The block then merges its warps (M =
    max m_w). Returns acc [G, D], m [G], l [G]."""
    G, D = qf.shape
    nch = -(-(hi - lo) // CHUNK)
    rounds = -(-nch // WARPS)
    keys = lo + torch.arange(rounds * WARPS * CHUNK).view(rounds, WARPS, CHUNK)  # round, warp, key
    vis = keys < hi
    keys = keys.clamp(max=hi - 1)
    m = torch.full((WARPS, G), NEG)
    l = torch.zeros(WARPS, G)
    acc = torch.zeros(WARPS, G, D)
    for r in range(rounds):
        k, v = kf[keys[r]], vf[keys[r]]  # [W, C, D]
        s = torch.einsum("gd,wcd->wgc", qf, k)
        s = torch.where(vis[r][:, None], s, torch.full_like(s, NEG))
        m_next = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_next)
        p = torch.where(vis[r][:, None], torch.exp(s - m_next[..., None]), torch.zeros_like(s))
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum("wgc,wcd->wgd", p.bfloat16().float(), v)
        m = m_next
    nvw = min(WARPS, nch)
    m, l, acc = m[:nvw], l[:nvw], acc[:nvw]
    M = m.amax(0)
    w = torch.exp(m - M)
    return (w[..., None] * acc).sum(0), M, (w * l).sum(0)


def _merge(parts):
    """The merge kernel: out = sum_p e^(m_p - M) acc_p / sum_p e^(m_p - M) l_p;
    no partial at all gives 0."""
    if not parts:
        return None
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    M = m.amax(0)
    w = torch.exp(m - M)
    den = (w * l).sum(0)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return ((w[..., None] * acc).sum(0) / den[:, None]).bfloat16()


def _replay(q, k, v, cs, valid, bucket, sms, drop=None):
    """The kernel's output [B, 1, Hq, D] from the partition and the replayed
    arithmetic; ``drop``: a (block, b, hk) partial the merge leaves out.
    Returns (out, {(block, b, hk): partial})."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    span = min(bucket, k.shape[2])
    row_keys = flash.decode_row_keys(cs, valid, span)
    nblocks = flash.decode_grid(B, Hkv, span, sms)
    scale = float(torch.tensor(D**-0.5, dtype=torch.bfloat16))
    parts = {}
    for p, segs in enumerate(flash.decode_partition(row_keys, Hkv, nblocks)):
        for b, hk, lo, hi in segs:
            qf = (q[b, 0, hk * G:(hk + 1) * G] * scale).float()  # the scale folded into q in bf16
            parts[(p, b, hk)] = _segment_state(qf, k[b, hk].float(), v[b, hk].float(), lo, hi)
    out = torch.zeros_like(q)
    for b in range(B):
        for hk in range(Hkv):
            got = [parts[(p, b, hk)] for p in flash.decode_merge_blocks(row_keys, Hkv, nblocks, b, hk)
                   if (p, b, hk) != drop]
            if got:
                out[b, 0, hk * G:(hk + 1) * G] = _merge(got)
    return out, parts


def _inputs(B, Hkv, T, G=4, seed=5):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, 1, Hkv * G, 128, generator=gen) * 4.0).bfloat16()  # peaked, as on the card
    k, v = (torch.randn(B, Hkv, T, 128, generator=gen).bfloat16() for _ in range(2))
    return q, k, v


def _within(got, plain):
    return bool(((got.float() - plain.float()).abs() <= flash.kernel_tolerance(plain)).all())


@pytest.mark.parametrize("sms", [3, H100_SMS])
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("hf", range(1, 9))
def test_partitioned_decode_replay_within_kernel_tolerance(hf, B, sms):
    """Mixed lengths, freed rows at stale lengths (some past the bucket), the
    main path's query group of 4; a grid of a few blocks (several pairs a
    block) and of the H100's (several blocks a pair)."""
    bucket = 1024
    cs, valid = _pool_lengths(B, seed=hf + 10 * B, bucket=bucket)
    q, k, v = _inputs(B, hf, 3 * bucket, seed=hf + B)
    plain = flash.full_cache_attention_plain(q, k, v, torch.tensor(cs), bucket=bucket, valid=torch.tensor(valid))
    got, _ = _replay(q, k, v, cs, valid, bucket, sms)
    assert _within(got, plain)
    freed = [b for b in range(B) if not valid[b]]
    assert bool((got[freed] == 0).all()) and bool((plain[freed] == 0).all())  # a freed row gives 0


@pytest.mark.parametrize("cs,bucket", [
    (16000, 16384),  # the main path's decode: each pair over 66 blocks
    (16383, 16384),  # the last tile full
    (16001, 16384),  # an odd tail: the last chunk holds two keys
    (0, 16384),  # one key in all: one block
    (300, 512),  # fewer tiles than blocks: one block a pair
])
def test_one_sequence_decode_replay_within_kernel_tolerance(cs, bucket):
    q, k, v = _inputs(1, 4, bucket)
    got, _ = _replay(q, k, v, [cs], None, bucket, H100_SMS)
    assert _within(got, flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_partitioned_decode_replay_rejects_a_segment_left_out(rank):
    """With peaked scores the bound catches a merge that loses one block's
    partial of 66: the one that weighs most in some head's row, the next,
    and the third."""
    cs, bucket = 16000, 16384
    q, k, v = _inputs(1, 4, bucket)
    plain = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket)
    _, parts = _replay(q, k, v, [cs], None, bucket, H100_SMS)
    # the weight each partial carries in the merged rows of its pair's heads
    weight = {}
    for hk in range(4):
        mine = {key: part for key, part in parts.items() if key[2] == hk}
        m = torch.stack([part[1] for part in mine.values()])
        share = torch.exp(m - m.amax(0)) * torch.stack([part[2] for part in mine.values()])
        share = share / share.sum(0)
        weight.update({key: float(share[i].max()) for i, key in enumerate(mine)})
    drop = sorted(weight, key=weight.get, reverse=True)[rank]
    assert weight[drop] > 2.0**-5, "the dropped partial carries too little to show"
    got, _ = _replay(q, k, v, [cs], None, bucket, H100_SMS, drop=drop)
    assert not _within(got, plain)


def test_no_visible_key_gives_zero():
    """A row with no query has no partial: its heads' rows are 0, as the
    merge kernel's l == 0 -> 1 gives; so is a merge of empty states."""
    acc, m, l = torch.zeros(8, 128), torch.full((8,), NEG), torch.zeros(8)
    out = _merge([(acc, m, l)] * 3)
    assert bool(torch.isfinite(out.float()).all()) and bool((out == 0).all())
    q, k, v = _inputs(2, 2, 512)
    got, _ = _replay(q, k, v, [100, 400], [0, 0], 512, H100_SMS)
    assert bool((got == 0).all())
    assert bool((flash.full_cache_attention_plain(q, k, v, torch.tensor([100, 400]), bucket=512,
                                                  valid=torch.tensor([0, 0])) == 0).all())


def test_params_from_numpy_defaults_to_the_card():
    """Like every entry point of the port: the card unless the caller says
    "cpu", and no fallback where there is no card."""
    tree = {"final_norm": np.ones(4, np.float32), "layers": [{"input_norm": np.ones(4, np.float32)}]}
    assert inspect.signature(params_from_numpy).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["final_norm"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_numpy(tree)
    assert params_from_numpy(tree, "cpu")["layers"][0]["input_norm"].device.type == "cpu"
