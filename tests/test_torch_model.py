"""The port's model forward against the JAX package's, on the CPU.

Counterparts of tests/test_model.py:117-230: all-full heads equal full
attention, chunked prefill equals monolithic prefill, mixed and
heterogeneous head splits (with a partial tail chunk), teacher-forced
decode. Each compares the port's ``forward_chunk`` hidden states (and cache
contents) with the JAX ``forward_chunk`` (attn_impl="ref") at atol 3e-4,
float32, with the same numpy-drawn weights fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu import config as jconfig
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch import config as tconfig
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy

ATOL = 3e-4
# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)
# One compiled program per (config, chunk shape): op-by-op dispatch of the
# decode step's interpret-mode Pallas writes costs seconds per call.
j_forward_chunk = jax.jit(jllama.forward_chunk, static_argnums=(1, 2))


def numpy_params(jcfg, seed):
    """A JAX-layout params tree with every leaf drawn from a numpy seed:
    projections N(0, 1/fan_in), embeddings N(0, 0.02^2), norms 1 + N(0, 0.01),
    biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "embed":
            w = 0.02 * rng.standard_normal(leaf.shape)
        elif leaf.ndim == 2:
            w = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        elif name.endswith("norm"):
            w = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            w = 0.1 * rng.standard_normal(leaf.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def models(name, seed, **changes):
    """(port cfg, JAX cfg, port params, JAX params) for a preset name."""
    tcfg = dataclasses.replace(tconfig.PRESETS[name], **changes.get("port", {}))
    jcfg = dataclasses.replace(jconfig.PRESETS[name], **changes.get("jax", {}))
    tree = numpy_params(jcfg, seed)
    return tcfg, jcfg, params_from_numpy(tree, "cpu", torch.float32), jax.tree_util.tree_map(jnp.asarray, tree)


def duos(cfg, num_full, sink=4, recent=8, chunk=16, max_size=256):
    if isinstance(num_full, int):
        num_full = (num_full,) * cfg.num_layers
    kw = dict(sink_size=sink, recent_size=recent, num_full_kv_heads=tuple(num_full),
              max_cache_size=max_size, prefill_chunk_size=chunk)
    return tconfig.DuoConfig(**kw), jconfig.DuoConfig(**kw)


def ids_for(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _chunks(ids, C):
    for start in range(0, ids.shape[1], C):
        chunk = ids[:, start : start + C]
        n = chunk.shape[1]
        yield np.pad(chunk, ((0, 0), (0, C - n))), n


def port_chunked(params, cfg, duo, ids):
    cache = tcache.init_cache(cfg, duo, ids.shape[0], torch.float32, "cpu")
    hs = []
    for chunk, n in _chunks(ids, duo.prefill_chunk_size):
        h, cache = tllama.forward_chunk(params, cfg, duo, cache, torch.as_tensor(chunk), n)
        hs.append(h[:, :n].numpy())
    return np.concatenate(hs, axis=1), cache


def jax_chunked(params, cfg, duo, ids):
    cache = jcache.init_cache(cfg, duo, ids.shape[0], jnp.float32)
    hs = []
    for chunk, n in _chunks(ids, duo.prefill_chunk_size):
        h, cache = j_forward_chunk(params, cfg, duo, cache, jnp.asarray(chunk), jnp.asarray(n, jnp.int32))
        hs.append(np.asarray(h)[:, :n])
    return np.concatenate(hs, axis=1), cache


def assert_caches_close(tc, jc):
    assert int(tc.length) == int(jc.length)
    for name in tcache.DuoCache.BUFFERS:
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


def test_all_full_heads_equals_full_attention():
    tcfg, jcfg, tp, jp = models("tiny-llama", 0)
    tduo, _ = duos(tcfg, tcfg.num_kv_heads)  # gates = 1 everywhere
    ids = ids_for(tcfg, 2, 40, 0)
    want = tllama.forward_full_attention(tp, tcfg, torch.as_tensor(ids)).numpy()
    got, _ = port_chunked(tp, tcfg, tduo, ids)
    np.testing.assert_allclose(got, want, atol=2e-4)
    jax_full = np.asarray(jllama.forward_full_attention(jp, jcfg, jnp.asarray(ids)))
    np.testing.assert_allclose(want, jax_full, atol=ATOL)


def test_chunked_equals_monolithic():
    tcfg, _, tp, _ = models("tiny-gqa", 1)
    ids = ids_for(tcfg, 1, 48, 3)
    h_mono, _ = port_chunked(tp, tcfg, duos(tcfg, tcfg.num_kv_heads, chunk=48)[0], ids)
    h_chunk, _ = port_chunked(tp, tcfg, duos(tcfg, tcfg.num_kv_heads, chunk=16)[0], ids)
    np.testing.assert_allclose(h_chunk, h_mono, atol=2e-4)


@pytest.mark.parametrize("num_full", [0, 1, 2])
@pytest.mark.parametrize("seq_len", [48, 41])  # whole chunks, and a partial tail chunk
def test_mixed_heads_match_jax(num_full, seq_len):
    tcfg, jcfg, tp, jp = models("tiny-gqa", 1)
    tduo, jduo = duos(tcfg, num_full)
    ids = ids_for(tcfg, 2, seq_len, 7)
    got, tc = port_chunked(tp, tcfg, tduo, ids)
    want, jc = jax_chunked(jp, jcfg, jduo, ids)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_caches_close(tc, jc)  # padded rows land where JAX puts them


def test_heterogeneous_layer_splits():
    tcfg, jcfg, tp, jp = models("tiny-gqa", 2)
    tduo, jduo = duos(tcfg, (0, 2, 4))
    ids = ids_for(tcfg, 1, 40, 11)
    got, tc = port_chunked(tp, tcfg, tduo, ids)
    want, jc = jax_chunked(jp, jcfg, jduo, ids)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("variant", ["precise_llama3", "bias_linear"])
def test_config_variants_match_jax(variant):
    """The precise RoPE path with llama3 scaling, and attention biases with
    linear RoPE scaling, through a mixed split with a partial tail."""
    if variant == "precise_llama3":
        kw = dict(rope_precise=True, rope_theta=500000.0)
        scaling = dict(rope_type="llama3", factor=8.0)
    else:
        kw = dict(attention_bias=True)
        scaling = dict(rope_type="linear", factor=4.0)
    tcfg, jcfg, tp, jp = models("tiny-gqa", 3, port=dict(kw, rope_scaling=tconfig.RopeScaling(**scaling)),
                                jax=dict(kw, rope_scaling=jconfig.RopeScaling(**scaling)))
    tduo, jduo = duos(tcfg, (1, 2, 3))
    ids = ids_for(tcfg, 1, 41, 12)
    got, _ = port_chunked(tp, tcfg, tduo, ids)
    want, _ = jax_chunked(jp, jcfg, jduo, ids)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_matches_jax():
    """Prefill two chunks, then teacher-force 12 single-token steps; every
    step's hidden state and the final caches match JAX."""
    tcfg, jcfg, tp, jp = models("tiny-gqa", 1)
    tduo, jduo = duos(tcfg, 2)
    ids = ids_for(tcfg, 1, 44, 13)
    _, tc = port_chunked(tp, tcfg, tduo, ids[:, :32])
    _, jc = jax_chunked(jp, jcfg, jduo, ids[:, :32])
    for pos in range(32, 44):
        th, tc = tllama.forward_chunk(tp, tcfg, tduo, tc, torch.as_tensor(ids[:, pos : pos + 1]), 1)
        jh, jc = j_forward_chunk(jp, jcfg, jduo, jc, jnp.asarray(ids[:, pos : pos + 1]),
                                 jnp.asarray(1, jnp.int32))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("q4", [False, True])
def test_decode_step_advances_the_length_in_place(q4):
    """A decode step adds to ``cache.length`` in place: the same tensor object
    holds the new length, so a step captured into a CUDA graph advances it on
    every replay (the prefill reads it on the host, outside any graph)."""
    tcfg, _, tp, _ = models("tiny-gqa", 1)
    tduo, _ = duos(tcfg, 2)
    ids = ids_for(tcfg, 1, 21, 13)
    new_cache = tcache.init_cache_q4 if q4 else tcache.init_cache
    cache = new_cache(tcfg, tduo, 1, torch.float32, "cpu")
    length = cache.length
    _, cache = tllama.forward_chunk(tp, tcfg, tduo, cache, torch.as_tensor(ids[:, :16]), 16)
    for pos in range(16, 21):
        _, cache = tllama.forward_chunk(tp, tcfg, tduo, cache, torch.as_tensor(ids[:, pos : pos + 1]), 1)
        assert cache.length is length and int(length) == pos + 1
