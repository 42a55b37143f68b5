"""The port's ops against the JAX package's, on the CPU.

The plain PyTorch versions of the attention kernels and of the in-place
writes are held against the JAX Pallas kernels (interpret mode on the CPU,
as tests/test_flash.py runs them) and against the JAX oracle; the masks,
RoPE tables and RMSNorm against their JAX counterparts. Inputs come from a
numpy seed and feed both packages; float32 throughout.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu.config import TINY_GQA as J_TINY_GQA
from duo_attention_tpu.config import RopeScaling as JRopeScaling
from duo_attention_tpu.ops import flash as jflash
from duo_attention_tpu.ops import inplace as jinplace
from duo_attention_tpu.ops import norm as jnorm
from duo_attention_tpu.ops import rope as jrope
from duo_attention_tpu.ops.attention_ref import masked_attention as j_masked_attention
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch.config import TINY_GQA, RopeScaling
from duo_attention_tpu_torch.ops import flash, inplace, norm, rope

ATOL = 2e-3  # attention, as tests/test_flash.py holds the kernels to the oracle
# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


# ---------------------------------------------------------------------------
# full_cache_attention
# ---------------------------------------------------------------------------


def _full_inputs(seed, B, S, Hq=4, Hkv=2, D=32, T=512):
    rng = np.random.default_rng(seed)
    return rand(rng, B, S, Hq, D), rand(rng, B, Hkv, T, D), rand(rng, B, Hkv, T, D)


def _full_oracle(q, k, v, cs):
    """JAX masked_attention with mask slot <= qpos, per sequence."""
    B, S = q.shape[:2]
    cs = np.broadcast_to(np.asarray(cs).reshape(-1), (B,))
    outs = []
    for b in range(B):
        mask = jcache.full_mask(jnp.arange(S) + int(cs[b]), k.shape[2])[None, None]
        outs.append(np.asarray(j_masked_attention(
            j(q[b : b + 1]), j(k[b : b + 1].transpose(0, 2, 1, 3)),
            j(v[b : b + 1].transpose(0, 2, 1, 3)), mask)))
    return np.concatenate(outs)


@pytest.mark.parametrize("cs_val", [0, 64, 200])
@pytest.mark.parametrize("S", [64, 1])
def test_full_cache_attention_matches_jax(cs_val, S):
    q, k, v = _full_inputs(0, 2, S)
    got = flash.full_cache_attention(t(q), t(k), t(v), cs_val).numpy()
    pallas = np.asarray(jflash.full_cache_attention(j(q), j(k), j(v), jnp.asarray(cs_val, jnp.int32)))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, _full_oracle(q, k, v, cs_val), atol=ATOL)


@pytest.mark.parametrize("S,cs_vals", [(1, [5, 200, 444]), (64, [0, 300, 17])])
def test_full_cache_attention_per_batch_lengths(S, cs_vals):
    q, k, v = _full_inputs(1, len(cs_vals), S)
    cs = np.asarray(cs_vals, np.int32)
    got = flash.full_cache_attention(t(q), t(k), t(v), t(cs)).numpy()
    pallas = np.asarray(jflash.full_cache_attention(j(q), j(k), j(v), j(cs)))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, _full_oracle(q, k, v, cs), atol=ATOL)


@pytest.mark.parametrize("S", [128, 1])
def test_full_cache_attention_bucket_invariance(S):
    q, k, v = _full_inputs(2, 1, S, Hq=2, Hkv=1, T=1024)
    cs = 100
    whole = flash.full_cache_attention(t(q), t(k), t(v), cs, bucket=0).numpy()
    small = flash.full_cache_attention(t(q), t(k), t(v), cs, bucket=256).numpy()
    np.testing.assert_allclose(small, whole, atol=1e-5)
    pallas = np.asarray(jflash.full_cache_attention(j(q), j(k), j(v), jnp.asarray(cs), bucket=256))
    np.testing.assert_allclose(small, pallas, atol=ATOL)


def _bf16_kernel_numerics(q, k, v, mask):
    """The CUDA kernels' arithmetic in plain torch: scale folded into q in
    bf16, float32 scores and softmax, p rounded to bf16 before P.V, output
    rounded to bf16. q [B, S, Hq, D], k/v [B, Hkv, T, D] bf16, mask [S, T]."""
    G = q.shape[2] // k.shape[1]
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=torch.bfloat16))
    qf = (q * scale).float().transpose(1, 2)
    kf, vf = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    s = torch.where(mask, qf @ kf.transpose(-1, -2), torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), torch.tensor(0.0))
    out = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("S,Hq,Hkv,T,cs,dropped", [
    (1, 32, 8, 16384, 16000, (8192, 8704)),  # decode at 16k; 512 keys dropped
    (256, 8, 2, 2048, 1024, (512, 576)),  # prefill; one 64-key tile dropped
])
def test_kernel_tolerance_admits_rounding_and_rejects_dropped_keys(S, Hq, Hkv, T, cs, dropped):
    """flash.kernel_tolerance, the bound the CUDA kernels are held to on the
    card, admits the kernels' bf16 roundings on peaked scores and rejects the
    same arithmetic with a range of keys left out."""
    gen = torch.Generator().manual_seed(5)
    q = (torch.randn(1, S, Hq, 128, generator=gen) * 4.0).bfloat16()  # peaked, as on the card
    k, v = (torch.randn(1, Hkv, T, 128, generator=gen).bfloat16() for _ in range(2))
    plain = flash.full_cache_attention_plain(q, k, v, cs)
    mask = tcache.full_mask(cs + torch.arange(S), T)
    tol = flash.kernel_tolerance(plain)
    assert bool(((_bf16_kernel_numerics(q, k, v, mask).float() - plain.float()).abs() <= tol).all())
    mask[:, dropped[0] : dropped[1]] = False
    assert not bool(((_bf16_kernel_numerics(q, k, v, mask).float() - plain.float()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# streaming_cache_attention
# ---------------------------------------------------------------------------

SINK, RECENT, R, C = 16, 64, 256, 128


def _stream_inputs(seed, B, S, Hsq=4, Hs=2, D=32):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, S, Hsq, D), rand(rng, B, Hs, SINK + C, D), rand(rng, B, Hs, SINK + C, D),
            rand(rng, B, Hs, R, D), rand(rng, B, Hs, R, D))


def _stream_oracle(q, ks, vs, kr, vr, cs, total):
    B, S = q.shape[:2]
    cs = np.broadcast_to(np.asarray(cs).reshape(-1), (B,))
    total = np.broadcast_to(np.asarray(total).reshape(-1), (B,))
    outs = []
    for b in range(B):
        pos = jnp.arange(S) + int(cs[b])
        m = jnp.concatenate([
            jcache.sink_mask(pos, SINK, SINK),
            jcache.ring_mask(pos, R, jnp.asarray(int(total[b])), jnp.asarray(int(cs[b])), SINK, RECENT),
        ], axis=1)[None, None]
        k_cat = np.concatenate([ks[b : b + 1, :, :SINK], kr[b : b + 1]], axis=2)
        v_cat = np.concatenate([vs[b : b + 1, :, :SINK], vr[b : b + 1]], axis=2)
        outs.append(np.asarray(j_masked_attention(
            j(q[b : b + 1]), j(k_cat.transpose(0, 2, 1, 3)), j(v_cat.transpose(0, 2, 1, 3)), m)))
    return np.concatenate(outs)


@pytest.mark.parametrize(
    "S,cs_val",
    [(64, 0), (64, 64), (64, 448), (1, 37), (1, 500)],  # first/second chunk, wrapped ring, decode
)
def test_streaming_cache_attention_matches_jax(S, cs_val):
    q, ks, vs, kr, vr = _stream_inputs(4, 1, S)
    total = cs_val + S
    got = flash.streaming_cache_attention(
        t(q), t(ks), t(vs), t(kr), t(vr), cs_val, total, SINK, RECENT).numpy()
    pallas = np.asarray(jflash.streaming_cache_attention(
        j(q), j(ks), j(vs), j(kr), j(vr), jnp.asarray(cs_val), jnp.asarray(total), SINK, RECENT))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, _stream_oracle(q, ks, vs, kr, vr, cs_val, total), atol=ATOL)


@pytest.mark.parametrize("S,cs_vals", [(1, [37, 500]), (64, [0, 448])])
def test_streaming_cache_attention_per_batch_lengths(S, cs_vals):
    q, ks, vs, kr, vr = _stream_inputs(5, len(cs_vals), S)
    cs = np.asarray(cs_vals, np.int32)
    total = cs + S
    got = flash.streaming_cache_attention(
        t(q), t(ks), t(vs), t(kr), t(vr), t(cs), t(total), SINK, RECENT).numpy()
    pallas = np.asarray(jflash.streaming_cache_attention(
        j(q), j(ks), j(vs), j(kr), j(vr), j(cs), j(total), SINK, RECENT))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, _stream_oracle(q, ks, vs, kr, vr, cs, total), atol=ATOL)


# ---------------------------------------------------------------------------
# In-place writes: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [0, 13, 63, 70, [0, 31, 63], [5, 99, -3]])  # 70, 99: clamp to T-1
def test_write_row_matches_jax(pos):
    rng = np.random.default_rng(6)
    B, H, T, D = 3, 2, 64, 16
    buf, row = rand(rng, B, H, T, D), rand(rng, B, H, 1, D)
    pos_np = np.asarray(pos, np.int32)
    want = np.asarray(jinplace.write_row(j(buf), j(row), j(pos_np)))
    tb = t(buf)
    got = inplace.write_row(tb, t(row), t(pos_np))
    assert got is tb  # mutated in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos", [0, 37, 70, [0, 31, 63], [5, 99, -3]])
def test_write_row_pair_of_strided_rows_matches_jax(pos):
    """The decode step's form: K and V rows of the first H of Hkv heads, read
    in place as ``transpose`` views of [B, 1, Hkv, D] projections (not
    contiguous), written in one call; each buffer equals JAX's write_row of
    that row, bit for bit."""
    rng = np.random.default_rng(8)
    B, H, Hkv, T, D = 3, 2, 4, 64, 16
    kbuf, vbuf = rand(rng, B, H, T, D), rand(rng, B, H, T, D)
    kproj, vproj = rand(rng, B, 1, Hkv, D), rand(rng, B, 1, Hkv, D)
    pos_np = np.asarray(pos, np.int32)
    krow, vrow = t(kproj)[:, :, :H].transpose(1, 2), t(vproj)[:, :, :H].transpose(1, 2)
    assert not krow.is_contiguous() and krow.shape == (B, H, 1, D)
    tk, tv = t(kbuf), t(vbuf)
    got = inplace.write_row(tk, krow, t(pos_np), tv, vrow)
    assert got is tk  # mutated in place
    for buf, proj, tb in ((kbuf, kproj, tk), (vbuf, vproj, tv)):
        row = proj[:, :, :H].transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jinplace.write_row(j(buf), j(row), j(pos_np))))


@pytest.mark.parametrize("start", [3, 16, 40, 300, [0, 15, 16], [100, 255, 256], [511, 7, 1000]])
def test_write_streaming_rows_matches_jax(start):
    rng = np.random.default_rng(7)
    B, H, D, sink = 3, 2, 16, 16
    Ts, Rr = sink + 32, 256
    bufs = [rand(rng, B, H, Ts, D), rand(rng, B, H, Ts, D), rand(rng, B, H, Rr, D), rand(rng, B, H, Rr, D)]
    krow, vrow = rand(rng, B, H, 1, D), rand(rng, B, H, 1, D)
    st = np.asarray(start, np.int32)
    want = jinplace.write_streaming_rows(*map(j, bufs), j(krow), j(vrow), j(st), sink)
    tbufs = [t(x) for x in bufs]
    got = inplace.write_streaming_rows(*tbufs, t(krow), t(vrow), t(st), sink)
    for g, w, tb in zip(got, want, tbufs):
        assert g is tb
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Masks, RoPE, RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs,total", [(0, 16), (48, 64), (300, 316), ([37, 500], [38, 501])])
def test_masks_match_jax(cs, total):
    Rr, sink, recent = 64, 4, 8
    S = 16 if np.ndim(cs) == 0 else 1  # a prefill chunk, or one decode row per sequence
    cs_np, tot_np = np.asarray(cs, np.int32), np.asarray(total, np.int32)
    pos = (cs_np[..., None] if cs_np.ndim else cs_np) + np.arange(S, dtype=np.int32)
    np.testing.assert_array_equal(tcache.full_mask(t(pos), 400).numpy(),
                                  np.asarray(jcache.full_mask(j(pos), 400)))
    np.testing.assert_array_equal(tcache.sink_mask(t(pos), 12, sink).numpy(),
                                  np.asarray(jcache.sink_mask(j(pos), 12, sink)))
    np.testing.assert_array_equal(tcache.ring_slot_positions(Rr, t(tot_np)).numpy(),
                                  np.asarray(jcache.ring_slot_positions(Rr, j(tot_np))))
    np.testing.assert_array_equal(
        tcache.ring_mask(t(pos), Rr, t(tot_np), t(cs_np), sink, recent).numpy(),
        np.asarray(jcache.ring_mask(j(pos), Rr, j(tot_np), j(cs_np), sink, recent)))


ROPE_VARIANTS = {
    "default": dict(),
    "linear": dict(rope_scaling=("linear", 8.0)),
    "llama3": dict(rope_scaling=("llama3", 8.0), rope_theta=500000.0),
    "precise_1048k": dict(rope_precise=True, rope_theta=3580165449.0),
    "precise_llama3": dict(rope_precise=True, rope_scaling=("llama3", 8.0), rope_theta=500000.0),
}


def _rope_cfgs(variant):
    kw = dict(ROPE_VARIANTS[variant])
    tcfg, jcfg = TINY_GQA, J_TINY_GQA
    if "rope_scaling" in kw:
        kind, factor = kw.pop("rope_scaling")
        tcfg = dataclasses.replace(tcfg, rope_scaling=RopeScaling(rope_type=kind, factor=factor))
        jcfg = dataclasses.replace(jcfg, rope_scaling=JRopeScaling(rope_type=kind, factor=factor))
    return dataclasses.replace(tcfg, **kw), dataclasses.replace(jcfg, **kw)


@pytest.mark.parametrize("variant", sorted(ROPE_VARIANTS))
def test_rope_tables_match_jax(variant):
    tcfg, jcfg = _rope_cfgs(variant)
    if tcfg.rope_precise:  # the precise path exists for long positions
        pos = np.asarray([0, 1, 4095, 4096, 123457, 1048575, 4194303], np.int32)
    else:
        pos = np.arange(0, 3000, 7, dtype=np.int32)
    cos_t, sin_t = rope.rope_tables(tcfg, t(pos))
    cos_j, sin_j = jrope.rope_tables(jcfg, j(pos))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)
    np.testing.assert_allclose(rope.rope_inv_freq(tcfg).numpy(),
                               np.asarray(jrope.rope_inv_freq(jcfg)), rtol=1e-6)


def test_apply_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(8)
    x = rand(rng, 2, 5, 3, 32)
    pos = np.arange(10, 15, dtype=np.int32)
    cos_t, sin_t = rope.rope_tables(TINY_GQA, t(pos))
    cos_j, sin_j = jrope.rope_tables(J_TINY_GQA, j(pos))
    np.testing.assert_allclose(rope.apply_rope(t(x), cos_t[None], sin_t[None]).numpy(),
                               np.asarray(jrope.apply_rope(j(x), cos_j[None], sin_j[None])), atol=1e-5)
    h, w = rand(rng, 2, 5, 64), rand(rng, 64)
    np.testing.assert_allclose(norm.rms_norm(t(h), t(w), 1e-5).numpy(),
                               np.asarray(jnorm.rms_norm(j(h), j(w), 1e-5)), atol=1e-5)
