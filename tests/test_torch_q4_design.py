"""The design of the INT4 prefill kernel, replayed on the CPU.

``csrc/flash_q4.cu::prefill_q4_kernel`` unpacks each packed byte into two
bf16 nibbles with integer operations and one bf16x2 fma, and runs the online
softmax over 128-key tiles with the dequantization folded into the scores
(``s * ks + rowsum(q) * kz``) and the output (``p * vs`` rounded to bf16
before the product with the nibbles, ``p . vz`` summed beside the row sum).
Here the conversion is replayed bit for bit, the kernel's arithmetic is
replayed in plain torch and held to ``flash.kernel_tolerance_q4`` against
``full_cache_attention_q4_plain`` (the bound the kernel is held to on the
card), and the build's library name is shown to follow the headers a source
includes.
"""

import shutil

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.ops import _build, flash, quant

torch.set_num_threads(1)
NEG = -0.7 * 3.402823466e38  # the kernels' NEG_INF
LOG2E = 1.4426950408889634
BQ, BK, WG_ROWS = 128, 128, 64  # the kernel's query tile, key tile and warpgroup rows


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: byte i of the result is
    byte (s >> 4i) & 7 of the eight bytes of y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_bits_to_float(bits):
    return torch.from_numpy((bits.astype(np.uint32) << 16).view(np.float32).copy())


def _nibbles_to_bf16x2(x):
    """The kernel's nibbles_to_bf16x2: (x & 0x000F000F) | 0x43004300 holds two
    bf16 of 128 + n, and fma.rn.bf16x2(v, 1.0, -128.0) rounds once. Returns
    the two result halves' bf16 bits (low, high)."""
    biased = (x & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    halves = []
    for part in (biased & 0xFFFF, biased >> 16):
        v = _bf16_bits_to_float(part).double()
        r = (v * 1.0 + (-128.0)).to(torch.bfloat16)  # one rounding, as the fma
        halves.append(r.view(torch.int16).numpy().astype(np.uint16))
    return halves


def kernel_unpack(packed: np.ndarray) -> torch.Tensor:
    """The producer's unpack of [..., T2, D] packed bytes (D a multiple of 4)
    into [..., 2 T2, D] bf16, word by word as the kernel does it: key 2r from
    the low nibbles of row r, key 2r + 1 from the high ones."""
    *lead, T2, D = packed.shape
    words = np.ascontiguousarray(packed).view("<u4").astype(np.uint32)  # [..., T2, D/4]
    b01 = _byte_perm(words, np.zeros_like(words), 0x4140)
    b23 = _byte_perm(words, np.zeros_like(words), 0x4342)
    e0, e1 = _nibbles_to_bf16x2(b01)
    e2, e3 = _nibbles_to_bf16x2(b23)
    o0, o1 = _nibbles_to_bf16x2(b01 >> 4)
    o2, o3 = _nibbles_to_bf16x2(b23 >> 4)
    even = np.stack([e0, e1, e2, e3], axis=-1).reshape(*lead, T2, D)
    odd = np.stack([o0, o1, o2, o3], axis=-1).reshape(*lead, T2, D)
    out = np.stack([even, odd], axis=-2).reshape(*lead, 2 * T2, D)
    return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)


def test_nibble_to_bf16_conversion_is_exact_bit_for_bit():
    """Every byte value, in every byte position of a word: both nibbles come
    out as the bf16 of exactly that nibble, bit for bit."""
    values = np.arange(256, dtype=np.uint8)
    packed = np.stack([np.roll(values, s) for s in range(4)], axis=-1).reshape(256, 4)  # [rows, D = 4]
    got = kernel_unpack(packed[None])[0]  # [512, 4]: key 2r, key 2r + 1
    lo, hi = packed & 0x0F, packed >> 4
    want = torch.from_numpy(np.stack([lo, hi], axis=1).reshape(512, 4).astype(np.float32)).bfloat16()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the 16 nibbles one by one: 0x4300 | n is 128 + n, and minus 128 is n
    for n in range(16):
        assert float(_bf16_bits_to_float(np.array([0x4300 | n]))[0]) == 128.0 + n
    assert sorted(set(got.float().flatten().tolist())) == [float(n) for n in range(16)]


def kernel_replay(q, k_packed, k_scales, v_packed, v_scales, cs, span):
    """The prefill kernel's arithmetic in plain torch, block by block: query
    tiles of 128 rows as two warpgroups of 64, key tiles of 128 in order, the
    tiles wholly above a warpgroup's rows skipped, scales zeroed at and past
    the frontier, per-key masks, 2^x on (s - m) log2 e, p * vs rounded to bf16
    before the product with the nibbles, l and p . vz per row, out = (O + z) / l.
    q [B, S, Hq, D] bf16; the cache as full_cache_attention_q4 takes it."""
    B, S, Hq, D = q.shape
    Hkv = k_packed.shape[1]
    G = Hq // Hkv
    scale = float(torch.tensor(D**-0.5, dtype=torch.bfloat16))
    qs = (q * scale).float()  # the scale folded into q in bf16
    kn = kernel_unpack(k_packed.numpy()).float()  # [B, Hkv, T, D] nibbles
    vn = kernel_unpack(v_packed.numpy()).float()
    out = torch.zeros(B, S, Hq, D, dtype=torch.bfloat16)
    for b in range(B):
        c = int(cs[b])
        for h in range(Hq):
            hk = h // G
            for q0 in range(0, S, BQ):
                rows = min(BQ, S - q0)
                kend = min(span, c + q0 + rows)
                ntiles = -(-kend // BK)
                for w in range(2):
                    r_lo = q0 + w * WG_ROWS
                    r_hi = min(r_lo + WG_ROWS, S)
                    if r_lo >= S:
                        continue
                    qw = qs[b, r_lo:r_hi, h]  # [rows, D]
                    qpos = c + torch.arange(r_lo, r_hi)
                    qsum = qw.sum(-1)
                    n_wg = min(ntiles, (c + q0 + w * WG_ROWS + 63 + BK) // BK)
                    m = torch.full((len(qw),), NEG)
                    l = torch.zeros(len(qw))
                    z = torch.zeros(len(qw))
                    o = torch.zeros(len(qw), D)
                    for t in range(n_wg):
                        j = torch.arange(t * BK, (t + 1) * BK)
                        live = j < kend
                        jj = j.clamp(max=k_packed.shape[2] * 2 - 1)
                        sc4 = [s[b, hk, :, jj // 2].float() for s in (k_scales, v_scales)]
                        par = jj % 2
                        ks, kz = (torch.where(live, sc4[0][par + o2, torch.arange(BK)], 0.0) for o2 in (0, 2))
                        vs, vz = (torch.where(live, sc4[1][par + o2, torch.arange(BK)], 0.0) for o2 in (0, 2))
                        kt = torch.where(live[:, None], kn[b, hk, jj], 0.0)
                        vt = torch.where(live[:, None], vn[b, hk, jj], 0.0)
                        s = (qw @ kt.T) * ks + qsum[:, None] * kz
                        vis = live[None] & (j[None] <= qpos[:, None])
                        s = torch.where(vis, s, NEG)
                        mn = torch.maximum(m, s.amax(-1))
                        al = torch.exp2((m - mn) * LOG2E)
                        p = torch.where(vis, torch.exp2(s * LOG2E - (mn * LOG2E)[:, None]), 0.0)
                        l = al * l + p.sum(-1)
                        z = al * z + (p * vz).sum(-1)
                        o = al[:, None] * o + (p * vs).bfloat16().float() @ vt
                        m = mn
                    l = torch.where(l == 0, torch.ones_like(l), l)
                    out[b, r_lo:r_hi, h] = ((o + z[:, None]) / l[:, None]).bfloat16()
    return out


def _q4_inputs(B, S, Hq, Hkv, T, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, 128)).astype(np.float32) * 4.0).bfloat16()  # peaked
    kq, ks = quant.quantize_int4_paired(torch.from_numpy(rng.standard_normal((B, Hkv, T, 128)).astype(np.float32)).bfloat16())
    vq, vs = quant.quantize_int4_paired(torch.from_numpy(rng.standard_normal((B, Hkv, T, 128)).astype(np.float32)).bfloat16())
    return q, kq.contiguous(), ks.contiguous(), vq.contiguous(), vs.contiguous()


@pytest.mark.parametrize("B,S,Hq,Hkv,T,cs", [
    (1, 200, 2, 1, 512, [0]),  # one query tile and a ragged second; the first warpgroup skips tiles
    (1, 150, 2, 1, 640, [301]),  # odd start: the diagonal tile splits a byte pair; 4 key tiles
    (2, 70, 4, 2, 512, [128, 257]),  # a one-tile second warpgroup is empty; G = 2
    (1, 260, 1, 1, 768, [383]),  # three query tiles, one row in the last; odd frontier
])
def test_prefill_replay_within_kernel_tolerance(B, S, Hq, Hkv, T, cs):
    q, kq, ks, vq, vs = _q4_inputs(B, S, Hq, Hkv, T, seed=B * 1000 + S)
    cs_t = torch.tensor(cs, dtype=torch.int32)
    plain = flash.full_cache_attention_q4_plain(q, kq, ks, vq, vs, cs_t, bucket=T)
    # the cache past each frontier is uninitialised: NaN scales, 0xF nibbles
    kq_p, ks_p, vq_p, vs_p = (t.clone() for t in (kq, ks, vq, vs))
    for b in range(B):
        end = cs[b] + S
        for packed in (kq_p, vq_p):
            packed[b, :, (end + 1) // 2:] = 0xFF
            if end % 2:
                packed[b, :, end // 2] |= 0xF0
        for scales in (ks_p, vs_p):
            scales[b, :, :, (end + 1) // 2:] = float("nan")
            if end % 2:
                scales[b, :, 1::2, end // 2] = float("nan")
    got = kernel_replay(q, kq_p, ks_p, vq_p, vs_p, cs_t, span=T)
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - plain.float()).abs()
    assert bool((err <= flash.kernel_tolerance_q4(plain)).all()), float(err.max())


@pytest.mark.parametrize("source", ["flash", "flash_q4", "gemm"])
def test_library_path_follows_included_headers(tmp_path, monkeypatch, source):
    """A source's library name changes when a header it includes changes, so
    an edited header never reuses a stale build; a source that does not
    include it keeps its name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [p.name for p in _build.source_files(source)] == [f"{source}.cu", "hopper.cuh"]
    before, other = _build.library_path(source), _build.library_path("inplace")
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(source) != before
    assert _build.library_path("inplace") == other
