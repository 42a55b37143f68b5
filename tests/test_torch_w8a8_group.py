"""The grouped W8A8 linear and the in-place streaming write against the JAX
package, on the CPU.

``quant.w8a8_linear_group`` quantizes an input once and multiplies it by one
to three weights (on the card, one kernel launch at small M): its plain
version is held to JAX's ``w8a8_linear``, one call per weight, and bitwise to
the one-weight path. The model's grouped projections (wq/wk/wv; gate/up) must
leave ``forward_chunk`` bitwise unchanged, and hold to JAX within the W8A8
flip bounds of tests/test_torch_quant.py. ``write_streaming_rows`` reads its
rows in place from ``transpose`` views of the projection's output, as the
decode step hands them; it is held to the JAX Pallas kernel in interpret
mode. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.ops import inplace as jinplace
from duo_attention_tpu.ops import quant as jquant
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.ops import inplace, quant
from test_torch_model import duos, ids_for
from test_torch_quant import (
    FLIP_REL_FRO, TIGHT_ATOL, _q4_prefill_and_decode, q4_caches_differ, rel_fro, w8a8_models,
)

torch.set_num_threads(1)
WIDTHS = (384, 96, 160)  # output features of the group's weights (ragged against 16-column tiles: 96, 160)


def t(x):
    return torch.from_numpy(np.array(x))


def _weights(rng, n_weights, K=256):
    """JAX-quantized weights (w [in, out] -> int8 and per-column scales) and
    their port form ([out, in])."""
    jw, tw = [], []
    for n in WIDTHS[:n_weights]:
        w = (rng.standard_normal((K, n)) * 0.1).astype(np.float32)
        jwq, jws = jquant.quantize_weight_int8(jnp.asarray(w))
        jw.append((jwq, jws))
        tw.append((t(np.asarray(jwq).T.copy()), t(np.asarray(jws))))
    return jw, tw


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_weights", [1, 2, 3])
@pytest.mark.parametrize("M", [1, 3, 8, 40])
def test_w8a8_linear_group_matches_jax(M, n_weights, x_dtype, out_dtype):
    """Each output of the group against JAX's w8a8_linear of its weight (rtol
    1e-6, as tests/test_torch_quant.py::test_w8a8_linear_matches_jax), and
    bitwise against the port's one-weight path (quantize, then int8_matmul)."""
    rng = np.random.default_rng(100 * M + 10 * n_weights + len(x_dtype + out_dtype))
    jw, tw = _weights(rng, n_weights)
    x32 = rng.standard_normal((1, M, 256)).astype(np.float32) * 2
    x = t(x32).to(getattr(torch, x_dtype))
    jx = jnp.asarray(x32).astype(getattr(jnp, x_dtype))
    tout, jout = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    got = quant.w8a8_linear_group(x, tw, tout)
    assert isinstance(got, tuple) and len(got) == n_weights
    xq, xs = quant.quantize_act_per_token(x)
    for g, (jwq, jws), (wq, ws) in zip(got, jw, tw):
        assert g.dtype == tout and tuple(g.shape) == (1, M, wq.shape[0])
        want = np.asarray(jquant.w8a8_linear(jx, jwq, jws, out_dtype=jout).astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), want, rtol=1e-6)
        assert torch.equal(g, quant.int8_matmul(xq, xs, wq, ws, tout))
        assert torch.equal(g, quant.w8a8_linear(x, wq, ws, tout, plain=True))
    assert all(torch.equal(a, b) for a, b in zip(got, quant.w8a8_linear_group(x, tw, tout, plain=True)))


def test_grouped_projections_leave_forward_chunk_bitwise_unchanged(monkeypatch):
    """forward_chunk with the grouped projections (one quantization for wq,
    wk and wv, one for gate and up) equals, bit for bit, the forward with
    each projection quantizing its own input: hidden states and caches."""
    tcfg, _, tp, _ = w8a8_models("tiny-gqa", 5)
    tduo, _ = duos(tcfg, (1, 0, 3))
    ids = ids_for(tcfg, 2, 35, 21)

    def run():
        from duo_attention_tpu_torch import cache as tcache

        tc = tcache.init_cache_q4(tcfg, tduo, 2, torch.float32, "cpu")
        hs = []
        for start in range(0, 32, 16):
            h, tc = tllama.forward_chunk(tp, tcfg, tduo, tc, torch.as_tensor(ids[:, start : start + 16]), 16)
            hs.append(h)
        for pos in range(32, 35):
            h, tc = tllama.forward_chunk(tp, tcfg, tduo, tc, torch.as_tensor(ids[:, pos : pos + 1]), 1)
            hs.append(h)
        return torch.cat(hs, 1), tc

    grouped, gc = run()
    monkeypatch.setattr(tllama, "_proj_group",
                        lambda layer, x, names, plain=False: tuple(tllama._proj(layer, x, n, plain) for n in names))
    single, sc = run()
    assert torch.equal(grouped, single)
    for name in ("k_full_q", "k_full_s", "v_full_q", "v_full_s", "k_sink", "v_sink", "k_ring", "v_ring"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(gc, name), getattr(sc, name))), name


@pytest.mark.parametrize("split,seq_len", [((0, 0, 0), 37), ((3, 1, 2), 40)])
def test_forward_chunk_w8a8_q4_grouped_matches_jax(split, seq_len):
    """The W8A8KV4 forward with grouped projections and the streaming rows
    written from strided views, against JAX attn_impl="ref": chunked prefill
    then two decode steps, every input within the flip bounds of
    tests/test_torch_quant.py and at least one of six within 2e-5 with
    bitwise-equal caches (all-streaming layers, and mixed splits)."""
    tcfg, jcfg, tp, jp = w8a8_models("tiny-gqa", 6)
    tduo, jduo = duos(tcfg, split)
    tight = 0
    for seed in range(30, 36):
        ids = ids_for(tcfg, 2, seq_len + 2, seed)
        th, jh, tl, jl, tc, jc = _q4_prefill_and_decode(tp, jp, tcfg, jcfg, tduo, jduo, ids, seq_len)
        assert int(tc.length) == seq_len + 2
        assert rel_fro(th, jh) <= FLIP_REL_FRO and rel_fro(tl, jl) <= FLIP_REL_FRO
        differing, stream = q4_caches_differ(tc, jc)
        tight += (differing == 0 and max(stream, np.abs(th - jh).max(), np.abs(tl - jl).max()) <= TIGHT_ATOL)
    assert tight >= 1


@pytest.mark.parametrize("start", [3, 16, 40, 300, [0, 15, 16, 2], [100, 255, 256, 17], [511, 7, 1000, 16]])
def test_write_streaming_rows_strided_matches_jax(start):
    """K and V rows of the streaming heads (the last 2 of 4 KV heads), read
    in place as ``transpose`` views of [B, 1, Hkv, D] projections: sink
    slot min(start, sink), ring slot start mod R (the ring wraps past 256),
    starts before the sink is full; bitwise the JAX Pallas kernel's buffers."""
    rng = np.random.default_rng(9)
    B, Hkv, hf, D, sink = 4, 4, 2, 16, 16
    H, Ts, R = Hkv - hf, sink + 32, 256
    bufs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, Ts, D), (B, H, Ts, D), (B, H, R, D), (B, H, R, D))]
    kproj, vproj = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32) for _ in range(2))
    st = np.resize(np.asarray(start, np.int32), B if np.ndim(start) else ())
    krow, vrow = t(kproj)[:, :, hf:].transpose(1, 2), t(vproj)[:, :, hf:].transpose(1, 2)
    assert not krow.is_contiguous() and tuple(krow.shape) == (B, H, 1, D)
    want = jinplace.write_streaming_rows(*map(jnp.asarray, bufs), jnp.asarray(kproj[:, :, hf:].transpose(0, 2, 1, 3)),
                                         jnp.asarray(vproj[:, :, hf:].transpose(0, 2, 1, 3)), jnp.asarray(st), sink)
    tbufs = [t(b) for b in bufs]
    got = inplace.write_streaming_rows(*tbufs, krow, vrow, t(st), sink)
    for g, w, tb in zip(got, want, tbufs):
        assert g is tb
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
