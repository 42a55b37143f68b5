"""The design of the small-M W8A8 kernel (csrc/gemm.cu, w8a8_small_mma_kernel),
replayed on the CPU.

The kernel cannot run here, so what surrounds its arithmetic is modelled in
Python: the persistent column walk (``_walk``, the kernel's ``Group`` and
block ranges) must give every column of every matrix of a group to exactly
one block, and the whole partition (``_plan``, the launch's choice of row
count, K-chunks and ring; then row groups x blocks x K-chunks x tiles x
slabs x warps' 32-byte steps) must sum every (row, column, k) product of
every matrix exactly once and write every output once, from its own x row,
at its tile's last chunk. The in-kernel quantization (up to 8 rows) and
the row quantization's own launch (past 8) are replayed step by step in
float32 numpy, split over warps and lanes as the kernels split it, and must
equal ``quant.quantize_act_per_token`` bit for bit: a max is exact
in any order, the scale is two IEEE operations, and a quotient's rounding,
taken from the product by the reciprocal, falls back to the IEEE division
near a rounding tie. The card tests (tests/test_torch_kernels_cuda.py) hold
the kernel's own walk bitwise, at 132 blocks and at fewer blocks than
tiles.
"""

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.ops import quant

SMS = 132  # an H100's streaming multiprocessors
WARPS = 8  # the kernel's consumer warps (SM_WARPS)
TILE_N = 16  # output columns a tile (SM_TILE_N)
MAX_ROWS = 16  # x rows a block takes at most (SM_MAX_ROWS)
SLAB, MAX_RING, MIN_STAGES, SMEM = 1024, 200_000, 4, 232_448  # SM_SLAB, SM_MAX_RING, SM_MIN_STAGES, SMEM_LIMIT
STAGE = TILE_N * (SLAB + 16)  # SM_STAGE_BYTES


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


def _x_pitch(chunk):
    return ((chunk + 127) & ~127) + 16


def _smem(stages, rows, chunk, R, acc_tiles):
    """csrc/gemm.cu::small_smem: ring stages with their mbarriers, x, the
    reduction buffer and the kept sums (int32, 16 R a tile), absmax partials
    and row scales."""
    return (stages * (STAGE + 16) + rows * _x_pitch(chunk) + (2 * WARPS + acc_tiles) * TILE_N * R * 4
            + 2 * MAX_ROWS * 4)


def _plan(M, K, ns, sms):
    """The launch as csrc/gemm.cu::w8a8_small makes it: R = 8 x rows a block
    up to 8, else 16; one block an SM, at most one a tile; x whole where
    that leaves SM_MIN_STAGES ring stages, else the fewest K-chunks (whole
    slabs) that do, down to one slab; the blocks keep the sums of their
    longest range of tiles across chunks. None where the launch is refused
    (fewer than two stages)."""
    R = 8 if M <= 8 else MAX_ROWS
    rows = min(M, R)
    total = sum(-(-n // TILE_N) for n in ns)
    blocks = min(sms, total)
    n = 1
    while True:
        chunk = K if n == 1 else -(-(-(-K // n)) // SLAB) * SLAB
        acc = -(-total // blocks) if chunk < K else 0
        stages = max(0, min(SMEM - _smem(0, rows, chunk, R, acc), MAX_RING)) // (STAGE + 16)
        if stages >= MIN_STAGES or chunk <= SLAB:
            break
        n += 1
    if stages < 2:
        return None
    assert _smem(stages, rows, chunk, R, acc) <= SMEM
    return dict(R=R, rows=rows, blocks=blocks, chunk=chunk, chunks=-(-K // chunk), acc_tiles=acc, stages=stages)


def _b_operand_rows(R, rows):
    """The x row each n = 8 B operand's column j reads: ldmatrix x4 (R = 16)
    or x2 takes matrix i's row r from lane 8 i + r, whose address is x row
    min(8 (l >> 4) + (l & 7), rows - 1) at byte (l >> 3 & 1) 16; operand h is
    matrices 2 h (k bytes 0-15) and 2 h + 1 (16-31), column j their row j."""
    addr = {lane: (min(8 * (lane >> 4) + (lane & 7), rows - 1), ((lane >> 3) & 1) * 16) for lane in range(32)}
    got = {}
    for h in range(R // 8):
        for j in range(8):
            lo, hi = addr[16 * h + j], addr[16 * h + 8 + j]
            assert lo[0] == hi[0] and (lo[1], hi[1]) == (0, 16)
            got[h, j] = lo[0]
    return got


def _epilogue_outputs(R):
    """(x row, tile column) of each writing thread tid < 16 R: the sum of
    the warps' acc[h][e] of lane l, stored at h * 128 + 4 l + e, is mma's
    column n = l / 4 + 8 (e >> 1) and x row 8 h + 2 (l % 4) + (e & 1)."""
    out = []
    for tid in range(TILE_N * R):
        h, lane, e = tid >> 7, (tid >> 2) & 31, tid & 3
        out.append((8 * h + 2 * (lane & 3) + (e & 1), (lane >> 2) + 8 * (e >> 1)))
    return out


# (M, K, output widths, SMs): Mistral-7B's decode groups (wq+wk+wv, wo, gate+up,
# down, head) at the pool's row counts, row groups past 16 (the int8-input
# mode), ragged groups, and fewer blocks than tiles
MISTRAL = [((4096, 1024, 1024), 4096), ((4096,), 4096), ((14336, 14336), 4096), ((4096,), 14336), ((32000,), 4096)]
PARTITIONS = [(M, K, ns, sms) for ns, K in MISTRAL for M in (1, 8, 9, 12, 16) for sms in (SMS, 7)] + [
    (17, 4096, (4096,), SMS), (33, 14336, (4096,), SMS), (40, 7168, (4096,), 7),  # row groups
    (16, 1040, (1000, 24, 8), 7), (5, 48, (130, 257, 9), SMS), (16, 23824, (40,), SMS), (8, 23824, (40,), SMS),
    (12, 2064, (300, 17), 3),
]


@pytest.mark.parametrize("M,K,ns,sms", PARTITIONS)
def test_small_partition_sums_every_product_once(M, K, ns, sms):
    """Row groups x blocks x K-chunks x tiles x slabs x the warps' 32-byte
    steps: every (row, column, k) product of each matrix is summed exactly
    once, in the block that owns the column; each output is written once,
    at its tile's last chunk, from the sums of its own x row; a block keeps
    no more tiles' sums across chunks than the launch made room for."""
    plan = _plan(M, K, ns, sms)
    assert plan is not None
    R, chunk, chunks = plan["R"], plan["chunk"], plan["chunks"]
    assert chunk % SLAB == 0 or chunks == 1
    assert chunk + 16 <= _x_pitch(chunk)  # the half step past an odd chunk's end reads the zero pad
    steps_of = {}  # slab bytes -> steps, each taken by exactly one warp
    for nbytes in {min(SLAB, K - kb) for kb in range(0, K, SLAB)} | {min(SLAB, chunk)}:
        steps = -(-nbytes // 32)
        taken = sorted(q for w in range(WARPS) for q in range(w, steps, WARPS))
        assert taken == list(range(steps)) and steps * 32 - nbytes in (0, 16)
    outs = _epilogue_outputs(R)
    assert sorted(outs) == [(m, n) for m in range(R) for n in range(TILE_N)]
    slabs = -(-K // SLAB)
    seen = [np.zeros((M, n, slabs), np.int16) for n in ns]
    written = [np.zeros((M, n), np.int16) for n in ns]
    walk = _walk(ns, plan["blocks"])
    for y in range(-(-M // R)):
        m0, rows = y * R, min(R, M - y * R)
        b_rows = _b_operand_rows(R, rows)
        for tiles in walk:
            for c in range(chunks):
                k0, k1 = c * chunk, min(K, (c + 1) * chunk)
                for j, (mat, n0, cols) in enumerate(tiles):
                    for kb in range(k0, k1, SLAB):
                        seen[mat][m0 : m0 + rows, n0 : n0 + cols, kb // SLAB] += 1
                    if c + 1 < chunks:
                        assert j < plan["acc_tiles"]
                        continue
                    for m, n in outs:
                        if m < rows and n < cols:
                            assert b_rows[m // 8, m % 8] == m
                            written[mat][m0 + m, n0 + n] += 1
    assert all((s == 1).all() for s in seen)
    assert all((w == 1).all() for w in written)


@pytest.mark.parametrize("M,K,ns,sms,want", [
    # x whole at every decode shape up to 8 rows, as before row groups of 16
    *((M, K, ns, SMS, 1) for ns, K in MISTRAL for M in (1, 4, 8)),
    *((16, K, ns, SMS, 1) for ns, K in MISTRAL if K == 4096),
    (9, 14336, (4096,), SMS, 1), (12, 14336, (4096,), SMS, 2), (16, 14336, (4096,), SMS, 2),
    (16, 14336, (4096,), 7, 3),  # 37 tiles' sums kept beside x
    (16, 14336, (4096,), 1, None),  # 256 tiles' sums do not fit: refused
])
def test_small_plan_stages_x_whole_or_in_chunks(M, K, ns, sms, want):
    """Where the launch stages x whole and where in K-chunks: whole at every
    8B and Mistral decode shape up to 8 rows and at K = 4,096 up to 16 (one
    pass over the weights, as before at 8); the down projection's K = 14,336
    in 2 chunks from 12 rows; a launch whose blocks cannot keep their tiles'
    sums is refused."""
    plan = _plan(M, K, ns, sms)
    assert (plan and plan["chunks"]) == want
    if plan:
        assert plan["stages"] >= MIN_STAGES


@pytest.mark.parametrize("M,passes", [(1, 1), (8, 1), (9, 1), (16, 1), (17, 1), (128, 1), (129, 2), (4096, 32)])
def test_weight_passes_follow_the_route(M, passes):
    """gemm.weight_passes: one pass over each weight up to SMALL_M_MAX rows
    (the small-M kernel's one row group), then one per 128-row tile of the
    tiled kernel; a forced small route reads the weights once per row group."""
    from duo_attention_tpu_torch.ops import gemm

    assert gemm.SMALL_M_MAX == gemm.SMALL_ROWS == MAX_ROWS
    assert gemm.weight_passes(M) == passes
    assert -(-M // _plan(M, 4096, (4096,), SMS)["R"]) == (1 if M <= gemm.SMALL_M_MAX else -(-M // MAX_ROWS))


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


def _kernel_quantize(x: np.ndarray, chunk=None):
    """The small-M kernel's prologue on x [rows <= 8, K] float32 (csrc/gemm.cu
    stage_x): (row, part) pairs, up to 4 rows 8 // rows parts a row and warp
    w taking row w % rows, part w // rows; from 5 rows one part, warp w
    taking row w. A lane takes the groups of 16 values g = part * 32 + lane
    (mod parts * 32); lane maxima, then the warp's (shuffles), then the row's
    over its parts; scale = absmax / 127 + 1e-12 and q = clamp(quantize4(x,
    scale), -127, 127), each operation in float32. With ``chunk``, the maxima
    are taken over the whole row first and the values quantized a K-chunk at
    a time."""
    rows, K = x.shape
    assert rows <= WARPS
    parts = WARPS // rows if rows <= WARPS // 2 else 1
    groups = x.reshape(rows, K // 16, 16)
    pair_max = np.zeros(rows * parts, np.float32)
    for w in range(WARPS):
        for i in range(w, rows * parts, WARPS):
            r, p = i % rows, i // rows
            lanes = [np.max(np.abs(groups[r, g]), initial=np.float32(0))
                     for lane in range(32) for g in range(p * 32 + lane, K // 16, parts * 32)]
            pair_max[i] = np.max(np.asarray(lanes, np.float32), initial=np.float32(0))
    row_max = [np.max(pair_max[[p * rows + r for p in range(parts)]]) for r in range(rows)]
    return _quantize_with(x, row_max, chunk or K)


def _rows_kernel_quantize(x: np.ndarray, vector: int):
    """csrc/gemm.cu::w8a8_quantize_rows_kernel on x [rows, K] float32, the
    rows past 8: a block a row, thread t of 256 taking the vectors (of
    ``vector`` values) t + 256 j; thread maxima, the warps' (shuffles), then
    the block's over its 8 warps; the same scale and rounding."""
    rows, K = x.shape
    vecs = x.reshape(rows, K // vector, vector)
    row_max = []
    for r in range(rows):
        threads = [np.max(np.abs(vecs[r, t::256]), initial=np.float32(0)) for t in range(256)]
        warps = [np.max(np.asarray(threads[32 * w : 32 * w + 32], np.float32)) for w in range(8)]
        row_max.append(np.max(np.asarray(warps, np.float32)))
    return _quantize_with(x, row_max, K)


def _quantize_with(x, row_max, chunk):
    rows, K = x.shape
    q = np.empty((rows, K), np.int8)
    scale = np.empty((rows, 1), np.float32)
    for r in range(rows):
        s = np.float32(np.float32(row_max[r]) / np.float32(127.0)) + np.float32(1e-12)
        scale[r, 0] = s
        for k0 in range(0, K, chunk):
            q[r, k0 : k0 + chunk] = np.clip(_round_quotient(x[r, k0 : k0 + chunk], s), -127, 127).astype(np.int8)
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
    if case == "bf16 M=16":
        return rng.standard_normal((16, 4096)).astype(np.float32) * 3, torch.bfloat16
    if case == "K=14336 M=16":  # the down projection at the pool's 16 rows
        return rng.standard_normal((16, 14336)).astype(np.float32) * rng.uniform(0.1, 9, (16, 1)).astype(np.float32), \
            torch.bfloat16
    if case == "K=23808 M=8 in chunks":  # x staged in 2 K-chunks by the small-M kernel itself
        return rng.standard_normal((8, 23808)).astype(np.float32) * rng.uniform(0.1, 9, (8, 1)).astype(np.float32), \
            torch.bfloat16
    rows = {"f32 M=1": 1, "f32 M=5": 5, "f32 M=7": 7, "f32 M=9": 9, "f32 M=12": 12}[case]
    return rng.standard_normal((rows, 4096)).astype(np.float32), torch.float32


@pytest.mark.parametrize("case", ["ties", "zero row", "bf16", "K=14336", "f32 M=1", "f32 M=5", "f32 M=7",
                                  "K=23808 M=8 in chunks", "bf16 M=16", "K=14336 M=16", "f32 M=9", "f32 M=12"])
def test_in_kernel_quantization_is_bitwise_quantize_act_per_token(case):
    """Up to 8 rows the small-M kernel's prologue (whole, or in K-chunks);
    past them the row quantization's launch."""
    x_np, dtype = _rows(case, np.random.default_rng(len(case)))
    x = torch.from_numpy(x_np).to(dtype)
    want_q, want_s = quant.quantize_act_per_token(x)
    plan = _plan(*x.shape, (4096,), SMS)
    assert (plan["chunks"] > 1) == (case.endswith("in chunks") or case == "K=14336 M=16")
    if x.shape[0] > 8:
        got_q, got_s = _rows_kernel_quantize(x.float().numpy(), 16 // x.element_size())
    else:
        got_q, got_s = _kernel_quantize(x.float().numpy(), plan["chunk"])
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
