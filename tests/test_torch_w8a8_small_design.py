"""The design of the small-M W8A8 kernel (csrc/gemm.cu, w8a8_small_mma_kernel),
replayed on the CPU.

The kernel cannot run here, so what surrounds its arithmetic is modelled in
Python: the persistent column walk (``_walk``, the kernel's ``Group`` and
block ranges) must give every column of every matrix of a group to exactly
one block. The in-kernel quantization is replayed step by step in float32
numpy, split over warps and lanes as the kernel splits it, and must equal
``quant.quantize_act_per_token`` bit for bit: a max is exact in any order,
the scale is two IEEE operations, and a quotient's rounding, taken from the
product by the reciprocal, falls back to the IEEE division near a rounding
tie. The card tests (tests/test_torch_kernels_cuda.py) hold the kernel's own
walk bitwise, at 132 blocks and at fewer blocks than tiles.
"""

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.ops import quant

SMS = 132  # an H100's streaming multiprocessors
WARPS = 8  # the kernel's consumer warps (SM_WARPS)
TILE_N = 16  # output columns a tile (SM_TILE_N)


def _walk(ns, blocks):
    """The columns each block of the small-M kernel computes, as the kernel
    walks them: block b takes tiles [T b / blocks, T (b + 1) / blocks) of the
    T tiles of the group (each matrix's in turn), and a tile is (matrix,
    first column, columns), the last tile of a matrix ragged."""
    counts = [-(-n // TILE_N) for n in ns]
    total = sum(counts)
    walk = []
    for b in range(blocks):
        tiles = []
        for t in range(total * b // blocks, total * (b + 1) // blocks):
            mat = 0
            while mat + 1 < len(ns) and t >= counts[mat]:
                t -= counts[mat]
                mat += 1
            n0 = t * TILE_N
            tiles.append((mat, n0, min(TILE_N, ns[mat] - n0)))
        walk.append(tiles)
    return walk


@pytest.mark.parametrize("ns", [
    (4096, 1024, 1024),  # wq, wk, wv of the 8B model
    (14336, 14336),  # gate, up
    (4096,),  # wo, down
    (128256,),  # the head
    (100,), (8,), (1000, 24, 17), (130, 257, 9), (16, 1),  # ragged
])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_small_walk_covers_every_column_once(ns, sms):
    """Every column of each matrix of the group lands in exactly one block;
    a block's tiles are contiguous, 16 columns of one matrix each (the last
    of a matrix ragged); every block has work and the blocks' tile counts
    differ by at most one. The launch takes one block an SM, at most one a
    tile."""
    walk = _walk(ns, min(sms, sum(-(-n // TILE_N) for n in ns)))
    seen = [np.zeros(n, np.int64) for n in ns]
    for tiles in walk:
        assert tiles
        for (mat, n0, cols), nxt in zip(tiles, tiles[1:] + [None]):
            assert n0 % 16 == 0 and 1 <= cols <= 16 and (cols == 16 or n0 + cols == ns[mat])
            seen[mat][n0 : n0 + cols] += 1
            if nxt is not None:  # the next tile follows on, in this matrix or at the next one's start
                assert nxt[:2] in ((mat, n0 + 16), (mat + 1, 0))
    assert all((s == 1).all() for s in seen)
    counts = [len(tiles) for tiles in walk]
    assert max(counts) - min(counts) <= 1


NEAR_HALF = np.float32(2.0**-14)  # SM_NEAR_HALF in csrc/gemm.cu


ROUNDER = np.float32(1.5 * 2.0**23)  # SM_ROUNDER


def _round_quotient(x: np.ndarray, scale: np.float32) -> np.ndarray:
    """csrc/gemm.cu::quantize4: rint(x * (1 / scale)), each rounded to
    float32, as (y + 1.5 * 2^23) - 1.5 * 2^23, and rint of the IEEE quotient
    x / scale where the product lies within 2^-14 of a half-integer. Also
    checks that the sum's low byte is that rint as an int8."""
    inv = np.float32(np.float32(1.0) / scale)
    y = (x * inv).astype(np.float32)
    t = (y + ROUNDER).astype(np.float32)
    q = (t - ROUNDER).astype(np.float32)
    np.testing.assert_array_equal(q, np.rint(y))
    np.testing.assert_array_equal((t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8), q.astype(np.int8))
    near = np.abs(y - q) > np.float32(0.5) - NEAR_HALF
    return np.where(near, np.rint(x / scale), q).astype(np.float32)


def _kernel_quantize(x: np.ndarray):
    """The kernel's prologue on x [rows <= 8, K] float32: warp w takes row
    w % rows and part w // rows of the 8 // rows parts, a lane the groups of
    16 values g = part * 32 + lane (mod parts * 32); lane maxima, then the
    warp's (shuffles), then the row's over its warps; scale = absmax / 127 +
    1e-12 and q = clamp(quantize4(x, scale), -127, 127), each operation in
    float32."""
    rows, K = x.shape
    parts = WARPS // rows
    groups = x.reshape(rows, K // 16, 16)
    warp_max = np.zeros(WARPS, np.float32)
    for w in range(WARPS):
        r, p = w % rows, w // rows
        if p >= parts:
            continue
        lanes = [np.max(np.abs(groups[r, g]), initial=np.float32(0))
                 for lane in range(32) for g in range(p * 32 + lane, K // 16, parts * 32)]
        warp_max[w] = np.max(np.asarray(lanes, np.float32), initial=np.float32(0))
    q = np.empty((rows, K), np.int8)
    scale = np.empty((rows, 1), np.float32)
    for r in range(rows):
        row_max = np.max(warp_max[[p * rows + r for p in range(parts)]])
        s = np.float32(np.float32(row_max) / np.float32(127.0)) + np.float32(1e-12)
        scale[r, 0] = s
        q[r] = np.clip(_round_quotient(x[r], s), -127, 127).astype(np.int8)
    return q, scale


def _rows(case, rng):
    if case == "ties":
        # absmax 127 makes the scale exactly 1 (1e-12 is below half its ulp), so
        # x / scale sits on .5 ties: rint takes the even neighbour, as torch.round
        tie = np.resize(np.array([126.5, -126.5, 125.5, -0.5, 0.5, 1.5, -2.5, 127.0], np.float32), 64)
        # +-127.5 as the absmax: its quotient lands on the clamp
        edge = rng.standard_normal(64).astype(np.float32) * 40
        edge[:2] = 127.5, -127.5
        return np.stack([tie, edge]), torch.float32
    if case == "zero row":  # scale 1e-12, every q 0
        x = rng.standard_normal((3, 256)).astype(np.float32)
        x[1] = 0.0
        return x, torch.float32
    if case == "bf16":
        return rng.standard_normal((8, 4096)).astype(np.float32) * 3, torch.bfloat16
    if case == "K=14336":
        return rng.standard_normal((8, 14336)).astype(np.float32) * rng.uniform(0.1, 9, (8, 1)).astype(np.float32), \
            torch.bfloat16
    rows = {"f32 M=1": 1, "f32 M=5": 5, "f32 M=7": 7}[case]
    return rng.standard_normal((rows, 4096)).astype(np.float32), torch.float32


@pytest.mark.parametrize("case", ["ties", "zero row", "bf16", "K=14336", "f32 M=1", "f32 M=5", "f32 M=7"])
def test_in_kernel_quantization_is_bitwise_quantize_act_per_token(case):
    x_np, dtype = _rows(case, np.random.default_rng(len(case)))
    x = torch.from_numpy(x_np).to(dtype)
    want_q, want_s = quant.quantize_act_per_token(x)
    got_q, got_s = _kernel_quantize(x.float().numpy())
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))
    np.testing.assert_array_equal(got_q, want_q.numpy())
    if case == "ties":
        assert got_s[0, 0] == 1.0
        np.testing.assert_array_equal(got_q[0, :8], [126, -126, 126, 0, 0, 2, -2, 127])
        assert got_q[1, 0] == 127 and got_q[1, 1] == -127
    if case == "zero row":
        assert got_s[1, 0] == np.float32(1e-12) and not got_q[1].any()


def test_quotient_by_the_reciprocal_rounds_as_the_division():
    """quantize4's rounding against rint of the IEEE quotient on 891,440
    values: random rows over scales from 1e-6 to 1e4 (absmax / 127 + 1e-12,
    as the kernel makes them), and values placed on and a few ulps around
    every rounding tie k + 1/2 of |k| < 127, where the product by the
    reciprocal and the quotient can round apart; the fast path alone must
    disagree on some of those, or the test would not reach the exact path."""
    rng = np.random.default_rng(0)
    fast_only_differs = 0
    for absmax in np.float32(10.0) ** rng.uniform(-4, 6, 40).astype(np.float32):
        scale = np.float32(np.float32(absmax / np.float32(127.0)) + np.float32(1e-12))
        rows = [rng.uniform(-absmax, absmax, 20000).astype(np.float32)]
        ties = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * scale
        for ulps in range(-4, 5):
            rows.append(np.nextafter(ties, np.float32(np.inf) if ulps > 0 else np.float32(-np.inf)) if ulps else ties)
            for _ in range(abs(ulps) - 1):
                rows[-1] = np.nextafter(rows[-1], np.float32(np.inf) if ulps > 0 else np.float32(-np.inf))
        x = np.clip(np.concatenate(rows), -absmax, absmax).astype(np.float32)
        exact = np.rint(x / scale)
        np.testing.assert_array_equal(_round_quotient(x, scale), exact)
        fast_only_differs += int((np.rint(x * np.float32(np.float32(1.0) / scale)) != exact).sum())
    assert fast_only_differs > 0
