"""The design of the bf16 decode kernel, replayed on the CPU.

The CUDA kernel of ``csrc/flash.cu`` splits a (sequence, KV head)'s key range
over blocks by a plan made from the bucket, runs the online softmax per
split and merges the splits' states. Here the plan function itself is
tested, and the kernel's arithmetic is replayed in plain torch (per-tile
online softmax inside a split, p rounded to bf16 against the split's own
running max, float32 partials, the merge) and held to
``flash.kernel_tolerance`` against ``full_cache_attention_plain``: the bound
the kernel is held to on the card.
"""

import inspect

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import flash

torch.set_num_threads(1)
NEG = -0.7 * 3.402823466e38  # the kernels' NEG_INF


def _split_states(q, k, v, cs, nsplit, split_keys):
    """The decode kernel's per-split states for one sequence. q [Hq, D] bf16,
    k/v [Hkv, T, D] bf16, cs the query's position. Returns acc [nsplit, Hq, D],
    m and l [nsplit, Hq], float32. A split past the frontier stays at
    (0, NEG, 0)."""
    Hq, D = q.shape
    G = Hq // k.shape[0]
    scale = float(torch.tensor(D**-0.5, dtype=torch.bfloat16))
    qf = (q * scale).float()  # the scale folded into q in bf16
    kf, vf = (x.float().repeat_interleave(G, dim=0) for x in (k, v))
    tile = flash.DECODE_TILE_KEYS
    acc = torch.zeros(nsplit, Hq, D)
    m = torch.full((nsplit, Hq), NEG)
    l = torch.zeros(nsplit, Hq)
    kend = cs + 1
    for s in range(nsplit):
        lo, hi = s * split_keys, min(kend, (s + 1) * split_keys)
        for k0 in range(lo, hi, tile):
            k1 = min(k0 + tile, hi)
            sc = torch.einsum("hd,htd->ht", qf, kf[:, k0:k1])
            m_next = torch.maximum(m[s], sc.amax(-1))
            alpha = torch.exp(m[s] - m_next)
            p = torch.exp(sc - m_next[:, None])
            l[s] = alpha * l[s] + p.sum(-1)
            acc[s] = alpha[:, None] * acc[s] + torch.einsum(
                "ht,htd->hd", p.bfloat16().float(), vf[:, k0:k1])
            m[s] = m_next
    return acc, m, l


def _merge(acc, m, l, keep=None):
    """The merge kernel: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s."""
    if keep is not None:
        acc, m, l = acc[keep], m[keep], l[keep]
    M = m.amax(0)
    w = torch.exp(m - M)
    den = (w * l).sum(0)
    den = torch.where(den == 0, torch.ones_like(den), den)
    return ((w[..., None] * acc).sum(0) / den[:, None]).bfloat16()


def _decode_inputs(T, Hq=16, Hkv=4, seed=5):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(1, 1, Hq, 128, generator=gen) * 4.0).bfloat16()  # peaked, as on the card
    k, v = (torch.randn(1, Hkv, T, 128, generator=gen).bfloat16() for _ in range(2))
    return q, k, v


def _within(got, plain):
    return bool(((got.float() - plain.float()).abs() <= flash.kernel_tolerance(plain)).all())


@pytest.mark.parametrize("cs,bucket", [
    (16000, 16384),  # the main path's decode: 64 splits, the last one ragged
    (16383, 16384),  # every split full
    (5000, 16384),  # a short sequence in a long bucket: 44 empty splits
    (0, 16384),  # one key in all
    (300, 512),  # one split: the block writes the output itself
    (1000, 1024),  # a few splits
])
def test_split_decode_replay_within_kernel_tolerance(cs, bucket):
    q, k, v = _decode_inputs(bucket)
    nsplit, split_keys = flash.decode_split_plan(bucket, k.shape[1])
    acc, m, l = _split_states(q[0, 0], k[0], v[0], cs, nsplit, split_keys)
    first_empty = -(-(cs + 1) // split_keys)
    assert bool((l[first_empty:] == 0).all()) and bool((m[first_empty:] == NEG).all())
    plain = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket)
    assert _within(_merge(acc, m, l)[None, None], plain)
    # merging only the splits that hold keys gives the same row: empty ones weigh nothing
    assert torch.equal(_merge(acc, m, l), _merge(acc, m, l, keep=slice(0, first_empty)))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_split_decode_replay_rejects_a_split_left_out(rank):
    """With peaked scores the bound catches a merge that loses one split of 64:
    the split that weighs most in some head's row, the next, and the third."""
    cs, bucket = 16000, 16384
    q, k, v = _decode_inputs(bucket)
    nsplit, split_keys = flash.decode_split_plan(bucket, k.shape[1])
    acc, m, l = _split_states(q[0, 0], k[0], v[0], cs, nsplit, split_keys)
    plain = flash.full_cache_attention_plain(q, k, v, cs, bucket=bucket)
    # the weight each split carries in the merged row of some head
    share = (torch.exp(m - m.amax(0)) * l)
    share = share / share.sum(0)
    drop = int(share.amax(1).argsort(descending=True)[rank])
    assert float(share[drop].max()) > 2.0**-5, "the dropped split carries too little to show"
    keep = [s for s in range(nsplit) if s != drop]
    assert not _within(_merge(acc, m, l, keep=keep)[None, None], plain)


def test_no_visible_key_gives_zero():
    """Every split empty (no key at or below the frontier): M = NEG_INF, all
    weights 1, all sums 0, and the row is 0, as the kernels' l == 0 -> 1."""
    acc, m, l = torch.zeros(4, 8, 128), torch.full((4, 8), NEG), torch.zeros(4, 8)
    out = _merge(acc, m, l)
    assert bool(torch.isfinite(out.float()).all()) and bool((out == 0).all())


SPANS = [1, 127, 128, 129, 300, 512, 513, 1000, 4096, 12288, 16384, 20000, 32768]
HEADS = [1, 2, 3, 4, 6, 12, 24]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("span", SPANS)
def test_decode_split_plan(span, heads):
    nsplit, split_keys = flash.decode_split_plan(span, heads)
    assert nsplit * split_keys >= span  # every key has a split
    assert (nsplit - 1) * split_keys < span  # and no split starts past the span
    assert split_keys % flash.DECODE_TILE_KEYS == 0
    assert 1 <= nsplit <= flash.DECODE_MAX_SPLITS
    if span <= flash.DECODE_ONE_BLOCK_SPAN:
        assert nsplit == 1
    else:
        assert split_keys >= flash.DECODE_MIN_SPLIT_KEYS
    if span >= 16384 and heads <= 6:
        # the main path's layers: about two blocks an SM, or the cap (rounding a
        # split up to whole tiles may cost up to a quarter of them)
        assert nsplit * heads >= 0.75 * min(flash.DECODE_TARGET_BLOCKS, flash.DECODE_MAX_SPLITS * heads)
    # a host function of the bucket and the head count alone: nothing of the cache lengths
    assert list(inspect.signature(flash.decode_split_plan).parameters) == ["span", "heads"]
    assert flash.decode_split_plan(span, heads) == (nsplit, split_keys)


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
