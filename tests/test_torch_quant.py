"""The port's W8A8KV4 path against the JAX package's, on the CPU.

Quantization ops (bitwise), the INT4 cache writes (bitwise; the JAX decode
write runs its Pallas kernel in interpret mode), the int8 matrix product
(plain version against the Pallas GEMM in interpret mode), INT4 attention
(plain version against the Pallas kernels in interpret mode and against the
JAX dequantize-then-attend oracle), then the format as a whole: the model
forward with W8A8 params over a ``DuoCacheQ4``, ``DuoEngine(kv_quant="int4")``
greedy streams, and a counterpart of ``__graft_entry__.entry()``. Inputs and
weights come from a numpy seed and feed both packages; each tolerance is
stated where it is used.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu.engine import DuoEngine as JDuoEngine
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu.ops import flash as jflash
from duo_attention_tpu.ops import gemm as jgemm
from duo_attention_tpu.ops import quant as jquant
from duo_attention_tpu.ops.attention_ref import masked_attention as j_masked_attention
from duo_attention_tpu_torch import DuoEngine, init_params_w8a8, init_params_w8a8_random
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import flash, gemm, inplace, quant
from test_torch_model import _chunks, duos, ids_for, models, numpy_params

# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)
j_forward_chunk = jax.jit(jllama.forward_chunk, static_argnums=(1, 2), static_argnames=("attn_impl",))


def t(x):
    return torch.from_numpy(np.array(x))


def bits(x: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as its int16 bit patterns (numpy has no bfloat16)."""
    assert x.dtype == torch.bfloat16
    return x.view(torch.int16).numpy()


def jbits(x) -> np.ndarray:
    assert x.dtype == jnp.bfloat16
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.int16))


def jax_scales4(bs8, H):
    """The JAX cache's [B, 8H, T2] scale buffer -> rows 0-3 of each head's
    8-row group, [B, H, 4, T2] (rows 4-7 are padding for its compiler)."""
    B, _, T2 = bs8.shape
    return bs8.reshape(B, H, 8, T2)[:, :, :4]


# ---------------------------------------------------------------------------
# ops/quant.py: bitwise
# ---------------------------------------------------------------------------


def _kv_like(seed, *shape):
    """Rows with varied ranges, one constant row (scale = the 1e-8 floor) and
    values that sit on rounding ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.1, 4.0, shape[:-1] + (1,)).astype(np.float32)
    x[..., 0, :] = 0.75
    x[..., 1, :] = np.arange(shape[-1], dtype=np.float32) * 0.5  # (x - min) / scale hits .5 exactly
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_quantization_is_bitwise_jax(dtype):
    x = _kv_like(0, 2, 3, 64, 32)
    tx = t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = quant.quantize_int4_nibbles(tx)
    jq, js = jquant.quantize_int4_nibbles(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(s), jbits(js))  # the stored scale and zero-point are bf16
    packed, s = quant.quantize_int4(tx)
    jpacked, js = jquant.quantize_int4(jx)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), np.asarray(jquant.unpack_int4(jpacked)))
    np.testing.assert_array_equal(quant.dequantize_int4(packed, s).numpy(),
                                  np.asarray(jquant.dequantize_int4(jpacked, js)))
    p2, s4 = quant.quantize_int4_paired(tx)
    jp2, js4 = jquant.quantize_int4_paired(jx)
    assert p2.shape == (2, 3, 32, 32) and s4.shape == (2, 3, 4, 32) and s4.dtype == torch.bfloat16
    np.testing.assert_array_equal(p2.numpy(), np.asarray(jp2))
    np.testing.assert_array_equal(bits(s4), jbits(js4))
    # exact: nibble * scale + zero-point in float32, the same two operations
    np.testing.assert_array_equal(quant.dequantize_int4_paired(p2, s4).numpy(),
                                  np.asarray(jquant.dequantize_int4_paired(jp2, js4)))


def test_int4_roundtrip_error_is_half_a_step():
    x = t(_kv_like(1, 2, 64, 128))
    back = quant.dequantize_int4_paired(*quant.quantize_int4_paired(x))
    step = (x.amax(-1) - x.amin(-1)) / 15.0
    # half a step, plus the bf16 rounding of scale (15 steps of 2^-9 relative) and zero-point
    bound = 0.5 * step + 2.0**-8 * (15 * step + x.amin(-1).abs()) + 1e-6
    assert bool(((x - back).abs().amax(-1) <= bound).all())
    with pytest.raises(ValueError, match="even number of tokens"):
        quant.quantize_int4_paired(x[:, :63])


def test_int8_quantization_is_bitwise_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((96, 160)) * 0.1).astype(np.float32)  # JAX layout [in, out]
    w[:, 3] = 0.0  # an all-zero channel: scale is the 1e-12 floor
    wq, ws = quant.quantize_weight_int8(t(w.T.copy()))
    jwq, jws = jquant.quantize_weight_int8(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    x = (rng.standard_normal((2, 5, 96)) * 3).astype(np.float32)
    xq, xs = quant.quantize_act_per_token(t(x))
    jxq, jxs = jquant.quantize_act_per_token(jnp.asarray(x))
    assert xs.shape == (2, 5, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


def test_quantize_params_and_embeddings_are_bitwise_jax():
    """quantize_params_w8a8 + quantize_embeddings_int8 on the same float
    weights: the port's int8 tensors are the transposes of JAX's, its scales
    are JAX's, and params_from_numpy carries JAX's across unchanged."""
    tcfg, jcfg, tp, jp = models("tiny-gqa", 3)
    tq = quant.quantize_embeddings_int8(quant.quantize_params_w8a8(tp))
    jq = jquant.quantize_embeddings_int8(jquant.quantize_params_w8a8(dict(jp)))
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu", torch.float32)
    assert sorted(tq) == sorted(carried) == sorted(jq)
    assert "embed" not in tq and "lm_head" not in tq and "wq" not in tq["layers"][0]
    # JAX quantizes embed and lm_head inside jax.jit, where XLA fuses
    # absmax / 127 + 1e-12 and may round it once less than the three separate
    # IEEE operations do: those scales agree to one float32 ulp (rtol 1.2e-7),
    # and the int8 tables, whose rounding sees that ulp only at a tie, exactly
    # here. The layers' projections, quantized op by op, are bitwise below.
    for name in ("embed_q8", "embed_scale", "lm_head_q8", "lm_head_scale"):
        assert tq[name].dtype == carried[name].dtype == (torch.int8 if name.endswith("q8") else torch.float32)
        if name.endswith("q8"):
            np.testing.assert_array_equal(tq[name].numpy(), carried[name].numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(tq[name].numpy(), carried[name].numpy(), rtol=1.2e-7, atol=0, err_msg=name)
    np.testing.assert_array_equal(carried["lm_head_q8"].numpy(), np.asarray(jq["lm_head_q8"]).T)
    np.testing.assert_array_equal(carried["embed_q8"].numpy(), np.asarray(jq["embed_q8"]))
    for tl, cl, jl in zip(tq["layers"], carried["layers"], jq["layers"]):
        assert sorted(tl) == sorted(cl) == sorted(jl)
        for name in quant.QUANTIZED_PROJECTIONS:
            assert cl[name + "_q8"].dtype == torch.int8 and cl[name + "_scale"].dtype == torch.float32
            np.testing.assert_array_equal(tl[name + "_q8"].numpy(), cl[name + "_q8"].numpy(), err_msg=name)
            np.testing.assert_array_equal(cl[name + "_q8"].numpy(), np.asarray(jl[name + "_q8"]).T)
            np.testing.assert_array_equal(tl[name + "_scale"].numpy(), np.asarray(jl[name + "_scale"]))
    with pytest.raises(ValueError, match="must be int8"):
        params_from_numpy({"final_norm": np.ones(4), "layers": [{"wq_q8": np.ones((4, 4), np.float32)}]}, "cpu")
    with pytest.raises(ValueError, match="no counterpart"):
        params_from_numpy({"final_norm": np.ones(4), "layers": [{"moe_gate_q8": np.ones((4, 4), np.int8)}]}, "cpu")


@pytest.mark.parametrize("quantize_embeds", [False, True])
def test_init_params_w8a8_structure_and_seed(quantize_embeds):
    """Same seed, same params; the structure is quantize-after-init's; the
    layer-at-a-time init equals quantizing init_params' weights."""
    tcfg = models("tiny-gqa", 0)[0]
    a = init_params_w8a8(tcfg, 3, torch.float32, "cpu", quantize_embeds)
    b = init_params_w8a8(tcfg, 3, torch.float32, "cpu", quantize_embeds)
    ref = quant.quantize_params_w8a8(tllama.init_params(tcfg, 3, torch.float32, "cpu"))
    if quantize_embeds:
        ref = quant.quantize_embeddings_int8(ref)
    assert sorted(a) == sorted(ref) and len(a["layers"]) == tcfg.num_layers
    for x, y, z in zip(tllama_leaves(a), tllama_leaves(b), tllama_leaves(ref)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert ("embed_q8" in a) == quantize_embeds and a["layers"][0]["wq_q8"].dtype == torch.int8


def tllama_leaves(params):
    for key in sorted(params):
        if key == "layers":
            for layer in params[key]:
                yield from (layer[k] for k in sorted(layer))
        else:
            yield params[key]


@pytest.mark.parametrize("quantize_embeds", [False, True])
def test_init_params_w8a8_random_runs(quantize_embeds):
    tcfg = models("tiny-gqa", 0)[0]
    p = init_params_w8a8_random(tcfg, 1, "cpu", quantize_embeds)
    again = init_params_w8a8_random(tcfg, 1, "cpu", quantize_embeds)
    assert all(torch.equal(x, y) for x, y in zip(tllama_leaves(p), tllama_leaves(again)))
    assert ("embed_q8" in p and "lm_head_q8" in p) if quantize_embeds else ("embed" in p and "lm_head" in p)
    w = p["layers"][0]["w_down_q8"]
    assert w.dtype == torch.int8 and tuple(w.shape) == (tcfg.hidden_size, tcfg.intermediate_size)
    assert int(w.min()) >= -127 and float(p["layers"][0]["w_down_scale"][0]) == pytest.approx(
        tcfg.intermediate_size**-0.5 / 127.0)
    hidden = tllama.forward_full_attention(p, tcfg, torch.as_tensor(ids_for(tcfg, 1, 12, 0)))
    logits = tllama.logits_at(p, hidden, 11)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


def test_w8a8_entry_points_default_to_the_card(monkeypatch):
    """No device= means the card: with no GPU present each initialiser raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = models("tiny-gqa", 0)[0]
    tduo, _ = duos(tcfg, 1)
    for make in (lambda: init_params_w8a8(tcfg), lambda: init_params_w8a8_random(tcfg),
                 lambda: tcache.init_cache_q4(tcfg, tduo, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# INT4 cache writes: bitwise
# ---------------------------------------------------------------------------


def _q4_buffers(seed, B, H, T, D):
    """Non-zero packed bytes and scales, so an untouched byte shows."""
    rng = np.random.default_rng(seed)
    bq = rng.integers(0, 256, (B, H, T // 2, D)).astype(np.uint8)
    bs4 = rng.standard_normal((B, H, 4, T // 2)).astype(np.float32)
    return bq, t(bs4).bfloat16()


def _to_jax_scales8(bs4: torch.Tensor):
    B, H, _, T2 = bs4.shape
    s8 = torch.cat([bs4.float(), torch.zeros(B, H, 4, T2)], dim=2).reshape(B, 8 * H, T2)
    return jnp.asarray(s8.numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("S,start", [
    (16, 0), (16, 32), (32, 96), (32, 120),  # chunks at even starts; 120 clamps to pair-row 48
    (1, 4), (1, 5), (1, 127), (1, 500),  # one token at even and odd positions; 500 clamps to 127
    (1, [0, 7, 126]), (1, [9, 9, 300]),  # per-sequence positions
])
def test_write_full_q4_matches_jax(S, start):
    B, H, T, D = 3, 2, 128, 32
    bq, bs4 = _q4_buffers(S + 7 * int(np.sum(start)), B, H, T, D)
    inc = _kv_like(S + int(np.sum(start)), B, H, max(S, 2), D)[:, :, :S]
    st = np.asarray(start, np.int32)
    jq, js8 = jcache.write_full_q4(jnp.asarray(bq), _to_jax_scales8(bs4), jnp.asarray(inc), jnp.asarray(st))
    tq, ts = t(bq), bs4.clone()
    got_q, got_s = tcache.write_full_q4(tq, ts, t(inc), t(st))
    assert got_q is tq and got_s is ts  # mutated in place
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq))  # whole packed buffer
    np.testing.assert_array_equal(bits(got_s), jbits(jax_scales4(js8, H)))
    assert not np.array_equal(got_q.numpy(), bq)


def test_write_q4_token_keeps_the_partner_nibble():
    B, H, T, D = 1, 1, 16, 8
    bq, bs4 = _q4_buffers(3, B, H, T, D)
    row = t(_kv_like(4, B, H, 2, D)[:, :, 1:2])
    for pos, keep_mask in ((6, 0xF0), (7, 0x0F)):
        tq, ts = t(bq), bs4.clone()
        inplace.write_q4_token(tq, ts, row, pos)
        changed = tq.numpy() != bq
        assert changed[0, 0, 3].any() and not np.delete(changed, 3, axis=2).any()
        np.testing.assert_array_equal(tq.numpy()[0, 0, 3] & keep_mask, bq[0, 0, 3] & keep_mask)
        nib, sc = quant.quantize_int4_nibbles(row)
        np.testing.assert_array_equal((tq.numpy()[0, 0, 3] >> (4 * (pos % 2))) & 0xF, nib.numpy()[0, 0, 0])
        par = pos % 2
        assert torch.equal(ts[0, 0, [par, 2 + par], 3], sc[0, 0, :, 0])
        other = torch.ones(4, T // 2, dtype=torch.bool)
        other[[par, 2 + par], 3] = False
        assert torch.equal(ts[0, 0][other], bs4[0, 0][other])


def test_q4_cache_sizes_and_bytes_match_jax():
    tcfg, jcfg, _, _ = models("tiny-gqa", 0)
    tduo, jduo = duos(tcfg, (0, 2, 4), max_size=256)
    for decode_only in (False, True):
        tc = tcache.init_cache_q4(tcfg, tduo, 2, torch.float32, "cpu", decode_only)
        jc = jcache.init_cache_q4(jcfg, jduo, 2, jnp.float32, decode_only)
        for name in ("k_full_q", "v_full_q", "k_sink", "v_sink", "k_ring", "v_ring"):
            assert [tuple(b.shape) for b in getattr(tc, name)] == [tuple(b.shape) for b in getattr(jc, name)], name
        for name in ("k_full_s", "v_full_s"):  # 4 rows a head here, 8 (4 of them padding) in JAX
            for a, b in zip(getattr(tc, name), getattr(jc, name)):
                assert a.dtype == torch.bfloat16 and tuple(a.shape) == (2, b.shape[1] // 8, 4, b.shape[2])
        assert all(not b.any() for name in tc.BUFFERS for b in getattr(tc, name))
        scale_pad = sum(b.size * 2 // 2 for b in jc.k_full_s + jc.v_full_s)
        assert tcache.kv_memory_bytes(tc) == jcache.kv_memory_bytes(jc) - scale_pad
    fp = tcache.kv_memory_bytes(tcache.init_cache(tcfg, duos(tcfg, 4, max_size=4096)[0], 1, torch.bfloat16, "cpu"))
    q4 = tcache.kv_memory_bytes(tcache.init_cache_q4(tcfg, duos(tcfg, 4, max_size=4096)[0], 1, torch.bfloat16, "cpu"))
    assert fp / q4 > 2.5  # as tests/test_quant.py::test_kv_memory_int4_is_4x_smaller


# ---------------------------------------------------------------------------
# w8a8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_plain_matches_pallas_gemm(out_dtype):
    """The Pallas GEMM in interpret mode (M = 256, K = N = 256) and the
    dot_general form, against the port's plain version. The int32 sum is exact
    in all three; rtol 1e-6 as tests/test_quant.py holds the Pallas GEMM to
    dot_general (XLA may fuse the two scale multiplications differently)."""
    rng = np.random.default_rng(0)
    M = K = N = 256
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)  # JAX layout [in, out]
    xs = rng.uniform(0.001, 0.02, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.001, 0.02, (N,)).astype(np.float32)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    pallas = jgemm.w8a8_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws), out_dtype=jdt)
    dot = jquant.int8_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq), jnp.asarray(ws), out_dtype=jdt)
    got = gemm.w8a8_matmul(t(xq), t(xs), t(wq.T.copy()), t(ws), tdt)
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    rtol = 1e-6 if out_dtype == "float32" else 2.0**-7  # one bf16 ulp where a float32 ulp moves the rounding
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)), rtol=rtol)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(dot.astype(jnp.float32)), rtol=rtol)
    # and exactly the integer sum, scaled in float32 in the stated order
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    want = (acc.astype(np.float32) * xs) * ws
    np.testing.assert_array_equal(gemm.w8a8_matmul(t(xq), t(xs), t(wq.T.copy()), t(ws), torch.float32).numpy(), want)


def test_w8a8_matmul_plain_is_exact_where_float32_is_not():
    """K = 14336 at saturated operands: the sum, 231,225,344, is past 2^24."""
    K = 14336
    xq = torch.full((2, K), 127, dtype=torch.int8)
    wq = torch.full((3, K), -127, dtype=torch.int8)
    wq[1, ::2] = 126
    got = gemm.w8a8_matmul(xq, torch.ones(2, 1), wq, torch.ones(3), torch.float32)
    want = np.float32(np.array([-127 * 127 * K, (126 * 127 - 127 * 127) * K // 2, -127 * 127 * K], np.int64))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(want, (2, 3)))


@pytest.mark.parametrize("M", [1, 3, 40])
def test_w8a8_linear_matches_jax(M):
    """Small M (JAX's dot_general branch) through quantize-then-multiply;
    rtol 1e-6 as tests/test_quant.py:186-219, and int8_matmul is the same."""
    rng = np.random.default_rng(M)
    w = (rng.standard_normal((256, 384)) * 0.1).astype(np.float32)
    x = rng.standard_normal((1, M, 256)).astype(np.float32)
    jwq, jws = jquant.quantize_weight_int8(jnp.asarray(w))
    want = np.asarray(jquant.w8a8_linear(jnp.asarray(x), jwq, jws, out_dtype=jnp.float32))
    wq, ws = quant.quantize_weight_int8(t(w.T.copy()))
    got = quant.w8a8_linear(t(x), wq, ws, torch.float32)
    assert tuple(got.shape) == (1, M, 384)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    xq, xs = quant.quantize_act_per_token(t(x))
    np.testing.assert_array_equal(quant.int8_matmul(xq, xs, wq, ws, torch.float32).numpy(), got.numpy())
    assert torch.equal(quant.w8a8_linear(t(x), wq, ws, torch.float32, plain=True), got)


# ---------------------------------------------------------------------------
# full_cache_attention_q4
# ---------------------------------------------------------------------------


def _q4_attention_inputs(seed, B, S, Hq=4, Hkv=2, D=32, T=512):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    kq, ks4 = jquant.quantize_int4_paired(jnp.asarray(k))
    vq, vs4 = jquant.quantize_int4_paired(jnp.asarray(v))
    return q, (kq, ks4, vq, vs4)


def _q4_oracle(q, kq, ks4, vq, vs4, cs):
    """The JAX oracle: dequantize, then masked_attention with slot <= qpos."""
    B, S = q.shape[:2]
    T = kq.shape[2] * 2
    kd = jquant.dequantize_int4_paired(kq, ks4)
    vd = jquant.dequantize_int4_paired(vq, vs4)
    cs = np.broadcast_to(np.asarray(cs).reshape(-1), (B,))
    outs = []
    for b in range(B):
        mask = jcache.full_mask(jnp.arange(S) + int(cs[b]), T)[None, None]
        outs.append(np.asarray(j_masked_attention(
            jnp.asarray(q[b : b + 1]), kd[b : b + 1].transpose(0, 2, 1, 3), vd[b : b + 1].transpose(0, 2, 1, 3), mask)))
    return np.concatenate(outs)


def _port_q4_args(kq, ks4, vq, vs4):
    return (t(kq), t(np.asarray(ks4.astype(jnp.float32))).bfloat16(),
            t(vq), t(np.asarray(vs4.astype(jnp.float32))).bfloat16())


@pytest.mark.parametrize("S,cs,T,bucket", [
    (64, 100, 512, 0), (256, 100, 512, 0), (1, 300, 512, 0), (1, 301, 512, 0), (1, 0, 512, 0),
    (1, 700, 32768, 1024),  # a short context in a big buffer, read through a small bucket
    (1, [5, 300, 511], 512, 0), (64, [0, 100, 447], 512, 0),  # per-sequence lengths
])
def test_q4_attention_matches_jax(S, cs, T, bucket):
    """The cases of tests/test_quant.py:64-97 and :248-275, plus [B] lengths.
    Against the Pallas kernels (interpret mode): atol 2e-2, what JAX holds them
    to against its oracle (its decode mode requantizes q and p to int8).
    Against the oracle itself: atol 2e-5, float32 reassociation only."""
    B = np.size(cs)
    q, packed = _q4_attention_inputs(S + int(np.sum(cs)), B, S, T=T)
    kq, ks4, vq, vs4 = packed
    cs_np = np.asarray(cs, np.int32)
    got = flash.full_cache_attention_q4(t(q), *_port_q4_args(*packed), t(cs_np), bucket=bucket).numpy()
    np.testing.assert_allclose(got, _q4_oracle(q, *packed, cs_np), atol=2e-5)
    pallas = jflash.full_cache_attention_q4(
        jnp.asarray(q), kq, jquant.paired_scales_to_cache_layout(ks4), vq,
        jquant.paired_scales_to_cache_layout(vs4), jnp.asarray(cs_np), bucket=bucket)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-2)


def _q4_kernel_numerics(q, kq, ks4, vq, vs4, mask):
    """The CUDA INT4 kernels' arithmetic in plain torch: scale folded into q in
    bf16; s = (q.Kq) scale_t + rowsum(q) zp_t in float32; softmax in float32;
    p * vscale_t rounded to bf16 before the product with the nibbles; the
    zero-point term in float32; output rounded to bf16. q [B, S, Hq, D] bf16,
    packed [B, Hkv, T/2, D], scales [B, Hkv, 4, T/2] bf16, mask [S, T]."""
    G = q.shape[2] // kq.shape[1]
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=torch.bfloat16))
    qf = (q * scale).float().transpose(1, 2)  # [B, Hq, S, D]

    def planes(packed, s4):
        nib = torch.stack([packed & 0xF, packed >> 4], dim=-2).flatten(2, 3).float()  # [B, Hkv, T, D]
        sc = torch.stack([s4[:, :, 0], s4[:, :, 1]], dim=-1).flatten(2).float()  # [B, Hkv, T]
        zp = torch.stack([s4[:, :, 2], s4[:, :, 3]], dim=-1).flatten(2).float()
        return (x.repeat_interleave(G, dim=1) for x in (nib, sc, zp))

    knib, ksc, kzp = planes(kq, ks4)
    vnib, vsc, vzp = planes(vq, vs4)
    s = (qf @ knib.transpose(-1, -2)) * ksc[:, :, None] + qf.sum(-1, keepdim=True) * kzp[:, :, None]
    s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), torch.tensor(0.0))
    out = (p * vsc[:, :, None]).bfloat16().float() @ vnib + (p * vzp[:, :, None]).sum(-1, keepdim=True)
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-30)).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("S,Hq,Hkv,T,cs,dropped", [
    (1, 32, 8, 16384, 16000, (8192, 8704)),  # decode at 16k; 512 keys dropped
    (256, 8, 2, 2048, 1024, (512, 576)),  # prefill; one 64-key tile dropped
])
def test_q4_kernel_tolerance_admits_rounding_and_rejects_dropped_keys(S, Hq, Hkv, T, cs, dropped):
    """flash.kernel_tolerance_q4, the bound the INT4 kernels are held to on the
    card, admits their arithmetic (bf16 p * scale_t against nibbles) on peaked
    scores and rejects the same arithmetic with a range of keys left out."""
    gen = torch.Generator().manual_seed(5)
    q = (torch.randn(1, S, Hq, 128, generator=gen) * 4.0).bfloat16()  # peaked, as on the card
    kq, ks4 = quant.quantize_int4_paired(torch.randn(1, Hkv, T, 128, generator=gen).bfloat16())
    vq, vs4 = quant.quantize_int4_paired(torch.randn(1, Hkv, T, 128, generator=gen).bfloat16())
    plain = flash.full_cache_attention_q4_plain(q, kq, ks4, vq, vs4, cs)
    mask = tcache.full_mask(cs + torch.arange(S), T)
    tol = flash.kernel_tolerance_q4(plain)
    err = (_q4_kernel_numerics(q, kq, ks4, vq, vs4, mask).float() - plain.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    mask[:, dropped[0] : dropped[1]] = False
    err = (_q4_kernel_numerics(q, kq, ks4, vq, vs4, mask).float() - plain.float()).abs()
    assert not bool((err <= tol).all())


# ---------------------------------------------------------------------------
# The format as a whole
# ---------------------------------------------------------------------------


def w8a8_models(name, seed, **changes):
    """(port cfg, JAX cfg, port params, JAX params): float weights from a numpy
    seed, quantized by the JAX package (projections, embedding, lm head) and
    carried into the port through numpy."""
    tcfg, jcfg, _, _ = models(name, seed, **changes)
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg, seed))
    jp = jquant.quantize_embeddings_int8(jquant.quantize_params_w8a8(jp))
    return tcfg, jcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu", torch.float32), jp


# Rounding flips. Hidden states and K/V pass through int8 activations and an
# INT4 cache, which are step functions: where the two packages' float32 values
# differ in the last bits (another summation order in a norm, a softmax or a
# matrix product, about 1e-6), a value that sits on a rounding boundary can
# land on the other side. One flipped activation moves a projection by about
# 1e-3, which flips more roundings downstream, and one flipped K/V nibble moves
# that element by a whole step (range / 15, about 0.3). On a given machine a
# given input flips or does not, deterministically; over 18 inputs 10 did.
# Without a flip the packages agree to 2e-6 and bit for bit; with one, the
# largest hidden-state difference seen was 0.10 (relative Frobenius error
# 0.015), and downstream of it a few percent of the nibbles written. So every
# input is held to FLIP bounds: relative Frobenius error 0.05 for activations,
# three times what was seen, and 0.15 for the dequantized INT4 buffers, where
# each flipped nibble is a fifteenth of its row's range (JAX's own W8A8 and
# INT4 model tests allow 0.12 and 0.15). And of several inputs at least one
# must agree tightly, with bitwise-equal buffers, which flips cannot fake.
TIGHT_ATOL = 2e-5
FLIP_REL_FRO = 0.05
FLIP_CACHE_REL_FRO = 0.15
FLIP_LOGIT_GAP = 0.3  # three times the largest hidden-state move a flip was seen to cause


def rel_fro(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def q4_caches_differ(tc, jc):
    """Whole cache contents. Checks every buffer to the flip bounds (the full
    heads as the values they decode to) and returns (the number of differing
    packed bytes and bf16 scale bits among the full heads, the largest
    absolute difference in the streaming buffers)."""
    assert int(tc.length) == int(jc.length)
    differing, stream = 0, 0.0
    for li, kq in enumerate(tc.k_full_q):
        hf = kq.shape[1]
        if hf == 0:
            continue
        for tq_, ts_, jq_, js_ in ((kq, tc.k_full_s[li], jc.k_full_q[li], jc.k_full_s[li]),
                                   (tc.v_full_q[li], tc.v_full_s[li], jc.v_full_q[li], jc.v_full_s[li])):
            assert tuple(tq_.shape) == tuple(jq_.shape)
            js4 = jax_scales4(js_, hf)
            differing += int((tq_.numpy() != np.asarray(jq_)).sum()) + int((bits(ts_) != jbits(js4)).sum())
            assert rel_fro(quant.dequantize_int4_paired(tq_, ts_).numpy(),
                           np.asarray(jquant.dequantize_int4_paired(jq_, js4))) <= FLIP_CACHE_REL_FRO
    for name in ("k_sink", "v_sink", "k_ring", "v_ring"):
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            if a.numel():
                assert rel_fro(a.numpy(), np.asarray(b)) <= FLIP_REL_FRO, name
                stream = max(stream, float(np.abs(a.numpy() - np.asarray(b)).max()))
    return differing, stream


def _q4_prefill_and_decode(tp, jp, tcfg, jcfg, tduo, jduo, ids, seq_len):
    """Chunked prefill of ids[:, :seq_len], then teacher-forced decode of the
    rest, through both packages. Returns (port hidden, JAX hidden) over every
    valid position, the last step's logits of each, and the two caches."""
    B = ids.shape[0]
    tc = tcache.init_cache_q4(tcfg, tduo, B, torch.float32, "cpu")
    jc = jcache.init_cache_q4(jcfg, jduo, B, jnp.float32)
    ths, jhs = [], []
    for chunk, n in _chunks(ids[:, :seq_len], tduo.prefill_chunk_size):
        th, tc = tllama.forward_chunk(tp, tcfg, tduo, tc, torch.as_tensor(chunk), n)
        jh, jc = j_forward_chunk(jp, jcfg, jduo, jc, jnp.asarray(chunk), jnp.asarray(n, jnp.int32), attn_impl="ref")
        ths.append(th[:, :n].numpy())
        jhs.append(np.asarray(jh)[:, :n])
    for pos in range(seq_len, ids.shape[1]):
        th, tc = tllama.forward_chunk(tp, tcfg, tduo, tc, torch.as_tensor(ids[:, pos : pos + 1]), 1)
        jh, jc = j_forward_chunk(jp, jcfg, jduo, jc, jnp.asarray(ids[:, pos : pos + 1]),
                                 jnp.asarray(1, jnp.int32), attn_impl="ref")
        ths.append(th.numpy())
        jhs.append(np.asarray(jh))
    logits = tllama.logits_at(tp, th, 0)
    assert logits.dtype == torch.float32
    return (np.concatenate(ths, 1), np.concatenate(jhs, 1), logits.numpy(),
            np.asarray(jllama.logits_at(jp, jh, 0)), tc, jc)


@pytest.mark.parametrize("split,seq_len", [((0, 2, 4), 41), ((1, 1, 1), 48), ((2, 3, 4), 33)])
def test_forward_chunk_w8a8_q4_matches_jax(split, seq_len):
    """Chunked prefill (chunks of 16; 41 and 33 end in a partial chunk of odd
    length, so the first decode token shares a byte row with padding) then two
    decode steps, W8A8 params with int8 embedding and head over the INT4
    cache, against JAX attn_impl="ref": hidden states at every position, the
    last logits, and whole cache contents. Every input within the flip bounds;
    at least one of ten within 2e-5 with bitwise-equal cache contents."""
    tcfg, jcfg, tp, jp = w8a8_models("tiny-gqa", 1)
    tduo, jduo = duos(tcfg, split)
    tight = 0
    for seed in range(7, 17):
        ids = ids_for(tcfg, 2, seq_len + 2, seed)
        th, jh, tl, jl, tc, jc = _q4_prefill_and_decode(tp, jp, tcfg, jcfg, tduo, jduo, ids, seq_len)
        assert isinstance(tc, tcache.DuoCacheQ4) and int(tc.length) == seq_len + 2
        assert rel_fro(th, jh) <= FLIP_REL_FRO and rel_fro(tl, jl) <= FLIP_REL_FRO
        differing, stream = q4_caches_differ(tc, jc)
        tight += (differing == 0 and max(stream, np.abs(th - jh).max(), np.abs(tl - jl).max()) <= TIGHT_ATOL)
    assert tight >= 1


def test_tied_int8_embedding_head_matches_jax():
    """Tied embeddings with an int8 table: the table's per-row scale is the
    head's per-out-channel scale. Flip bounds on every prompt, tight on one."""
    tcfg, jcfg, tp, jp = w8a8_models("tiny-gqa", 2, port=dict(tie_word_embeddings=True),
                                     jax=dict(tie_word_embeddings=True))
    assert "lm_head_q8" not in tp and "embed_q8" in tp
    tight = 0
    for seed in range(3, 7):
        ids = ids_for(tcfg, 1, 24, seed)
        th = tllama.forward_full_attention(tp, tcfg, torch.as_tensor(ids))
        jh = jllama.forward_full_attention(jp, jcfg, jnp.asarray(ids))
        tl, jl = tllama.logits_at(tp, th, 5).numpy(), np.asarray(jllama.logits_at(jp, jh, 5))
        assert rel_fro(th.numpy(), np.asarray(jh)) <= FLIP_REL_FRO and rel_fro(tl, jl) <= FLIP_REL_FRO
        tight += np.abs(th.numpy() - np.asarray(jh)).max() <= TIGHT_ATOL and np.abs(tl - jl).max() <= TIGHT_ATOL
    assert tight >= 1


@pytest.mark.parametrize("B,split", [(1, (0, 2, 4)), (2, (1, 2, 3)), (1, (4, 4, 4))])
def test_generate_int4_matches_jax(B, split):
    """Greedy token streams of DuoEngine(kv_quant="int4") with W8A8 params
    against the JAX engine's: 41-token prompts (chunks of 16, 16 and an odd
    tail of 9), 12 new tokens, four prompts from fixed seeds. The streams are
    equal, except that a rounding flip (see above) may turn a near-tie: where
    a stream first departs, the port's own logits for that step, with JAX's
    tokens fed so far, must hold JAX's token within FLIP_LOGIT_GAP of the best;
    at least three of the four streams must be equal outright."""
    tcfg, jcfg, tp, jp = w8a8_models("tiny-gqa", 4)
    tduo, jduo = duos(tcfg, split)
    jeng = JDuoEngine(jp, jcfg, jduo, batch_size=B, dtype=jnp.float32, kv_quant="int4")
    eng = DuoEngine(tp, tcfg, tduo, batch_size=B, dtype=torch.float32, device="cpu", kv_quant="int4")
    equal = 0
    for seed in range(21, 25):
        ids = ids_for(tcfg, B, 41, seed)
        want, jc = jeng.generate(ids, max_new_tokens=12)
        want = np.asarray(want)
        got, tc = eng.generate(ids, max_new_tokens=12)
        assert isinstance(tc, tcache.DuoCacheQ4) and int(tc.length) == int(jc.length) == 41 + 12
        assert got.shape == want.shape == (B, 12)
        if np.array_equal(got, want):
            equal += 1
            continue
        for b in range(B):
            steps = np.nonzero(got[b] != want[b])[0]
            if len(steps):
                i = int(steps[0])
                _, logits = eng.prefill(np.concatenate([ids, want[:, :i]], axis=1))
                assert float(logits[b].max() - logits[b, want[b, i]]) <= FLIP_LOGIT_GAP
    assert equal >= 3
    again, _ = eng.generate(ids, max_new_tokens=12)
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="kv_quant"):
        DuoEngine(tp, tcfg, tduo, device="cpu", kv_quant="int8")


def test_graft_entry_counterpart_matches_entry():
    """The port's counterpart of __graft_entry__.entry(): its config, its
    params carried across through numpy, one prefill chunk and one decode step
    over the INT4 cache with the int8 head, in bf16 as entry() runs (its norms
    are bf16). entry() itself runs the Pallas kernels in interpret mode (INT4
    attention in its int8 decode mode, the Pallas GEMM, the in-place nibble
    write). bf16 activations round differently in the two frameworks, so int8
    roundings flip freely: the logits (standard deviation 0.98) agree to a
    relative Frobenius error of 0.1 (0.046 measured; JAX's own W8A8 and INT4
    model tests allow 0.12 and 0.15) and 0.35 elementwise (0.157 measured),
    and the port's argmax is JAX's, or within that 0.35 of JAX's best logit."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import entry

    from duo_attention_tpu_torch.config import DuoConfig, ModelConfig

    fn, (jp, jc, jids) = entry()
    want_logits, jc_after = jax.jit(fn)(jp, jc, jids)
    cfg = ModelConfig(vocab_size=2048, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, rope_theta=500000.0, max_position_embeddings=8192)
    duo = DuoConfig(sink_size=64, recent_size=128, num_full_kv_heads=(1,) * cfg.num_layers,
                    max_cache_size=2048, prefill_chunk_size=256)

    def to_numpy(x):  # numpy has no bfloat16
        return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)

    tp = params_from_numpy(jax.tree_util.tree_map(to_numpy, jp), "cpu", torch.bfloat16)
    assert tp["layers"][0]["wq_q8"].dtype == torch.int8 and tp["embed_scale"].dtype == torch.float32
    cache = tcache.init_cache_q4(cfg, duo, 1, torch.bfloat16, "cpu")
    ids = torch.as_tensor(np.array(jids)).long()
    hidden, cache = tllama.forward_chunk(tp, cfg, duo, cache, ids, full_bucket=512)
    tok = torch.argmax(tllama.logits_at(tp, hidden, ids.shape[1] - 1), dim=-1)
    hidden, cache = tllama.forward_chunk(tp, cfg, duo, cache, tok[:, None], full_bucket=512)
    got = tllama.logits_at(tp, hidden, 0).numpy()
    assert int(cache.length) == int(jc_after.length) == 257
    want = np.asarray(want_logits)
    assert got.shape == want.shape == (1, cfg.vocab_size) and np.isfinite(got).all()
    assert rel_fro(got, want) <= 0.1
    np.testing.assert_allclose(got, want, atol=0.35)
    assert float(want.max() - want[0, got.argmax()]) <= 0.35
