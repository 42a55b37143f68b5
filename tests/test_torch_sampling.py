"""The port's sampling (ops/sampling.py) against the JAX package's, on the CPU.

The port draws from JAX's own threefry2x32 stream, so: the keys, splits and
32-bit random words equal ``jax.random``'s bit for bit; the Gumbel noise
equals JAX's within 2 ulp at the scale of max(|g|, 1) (both take two
float32 logs, whose last bits differ between XLA's and torch's ``log``);
the sampled tokens of ``sample_tokens`` and ``sample_tokens_rowkeys`` equal
JAX's on the same logits and keys; and the port's sampled ``DuoEngine`` and
``ServingEngine`` streams equal the JAX engines' for seeds fixed up front.
Every test of tests/test_sampling.py is mirrored on the port (temperature,
top-p and top-k limits, the softmax distribution, per-row streams, the
engine and the serving pool).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.engine import DuoEngine as JDuoEngine
from duo_attention_tpu.ops import sampling as jsampling
from duo_attention_tpu.serving import Request as JRequest
from duo_attention_tpu.serving import ServingEngine as JServingEngine
from duo_attention_tpu_torch import DuoEngine, Request, ServingEngine
from duo_attention_tpu_torch.ops import sampling as S
from duo_attention_tpu_torch.ops.sampling import SamplingParams
from test_torch_model import duos, models

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 2**31 - 1)


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def jkey_words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_are_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(S.prng_key(seed, "cpu").numpy(), jkey_words(key))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(S.split(S.prng_key(seed, "cpu"), n).numpy(), jkey_words(jax.random.split(key, n)))
    # a batch of keys splits row by row, as vmap of jax.random.split
    keys = jax.random.split(key, 5)
    want = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    np.testing.assert_array_equal(S.split(t(jkey_words(keys)), 2).numpy(), jkey_words(want))


@pytest.mark.parametrize("shape", [(64,), (3, 128), (4, 128256)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_are_jax_bitwise_and_gumbel_within_2_ulp(seed, shape):
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(S.random_bits(S.prng_key(seed, "cpu"), shape).numpy(), bits)
    want = np.asarray(jax.random.gumbel(key, shape, jnp.float32, mode="low"))
    got = S.gumbel(S.prng_key(seed, "cpu"), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert float((np.abs(got - want) / ulp).max()) <= 2.0


def random_logits(rng, B, V, scale=3.0):
    return (scale * rng.standard_normal((B, V))).astype(np.float32)


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_sample_tokens_match_jax(top_p, top_k):
    rng = np.random.default_rng(2)
    B, V = 6, 1000
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.0, 2.0], np.float32)
    top_p_v = np.full(B, top_p, np.float32)
    top_k_v = np.full(B, top_k, np.int32)
    for seed in range(8):
        logits = random_logits(rng, B, V)
        key = jax.random.PRNGKey(seed)
        want = jsampling.sample_tokens(jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_p_v),
                                       jnp.asarray(top_k_v))
        got = S.sample_tokens(t(logits), S.prng_key(seed, "cpu"), t(temp), t(top_p_v), t(top_k_v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_tokens_rowkeys_match_jax():
    rng = np.random.default_rng(4)
    B, V = 5, 2000
    temp = np.asarray([1.0, 0.0, 0.8, 1.5, 1.0], np.float32)
    top_p = np.asarray([1.0, 1.0, 0.95, 0.9, 0.5], np.float32)
    top_k = np.asarray([0, 0, 50, 0, 3], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    tkeys = t(jkey_words(keys))
    for _ in range(6):
        logits = random_logits(rng, B, V)
        want, keys = jsampling.sample_tokens_rowkeys(jnp.asarray(logits), keys, jnp.asarray(temp),
                                                     jnp.asarray(top_p), jnp.asarray(top_k))
        got, tkeys = S.sample_tokens_rowkeys(t(logits), tkeys, t(temp), t(top_p), t(top_k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tkeys.numpy(), jkey_words(keys))


def test_params_to_vectors_match_jax():
    params = [None, SamplingParams(0.5, 0.9, 7, seed=3), SamplingParams()]
    for got, want in zip(S.params_to_vectors(params, 4), jsampling.params_to_vectors(params, 4)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


# --- tests/test_sampling.py, on the port -------------------------------------


def test_temperature_zero_rows_are_argmax():
    rng = np.random.default_rng(0)
    logits = t(rng.standard_normal((4, 64)), torch.float32)
    temp = torch.tensor([0.0, 1.0, 0.0, 2.0])
    out = S.sample_tokens(logits, S.prng_key(0, "cpu"), temp, torch.ones(4), torch.zeros(4, dtype=torch.int32))
    am = torch.argmax(logits, dim=-1)
    assert out[0] == am[0] and out[2] == am[2]


@pytest.mark.parametrize("knob", ["top_p", "top_k"])
def test_tight_filters_reproduce_greedy(knob):
    rng = np.random.default_rng(1)
    logits = t(rng.standard_normal((3, 128)), torch.float32)
    temp = torch.full((3,), 5.0)  # hot: without the filter this is diffuse
    top_p = torch.full((3,), 1e-9 if knob == "top_p" else 1.0)
    top_k = torch.full((3,), 1 if knob == "top_k" else 0, dtype=torch.int32)
    am = torch.argmax(logits, dim=-1)
    for seed in range(5):
        assert torch.equal(S.sample_tokens(logits, S.prng_key(seed, "cpu"), temp, top_p, top_k), am)


def test_top_p_excludes_tail():
    # probs ~ [0.71, 0.14, 0.14, ~0]: top_p=0.5 keeps only the head
    logits = torch.tensor([[2.0, 0.4, 0.4, -20.0]])
    for seed in range(8):
        out = S.sample_tokens(logits, S.prng_key(seed, "cpu"), torch.ones(1), torch.tensor([0.5]),
                              torch.zeros(1, dtype=torch.int32))
        assert int(out[0]) == 0
    # top_p=0.9 keeps the first three but never the -20 tail
    for seed in range(8):
        out = S.sample_tokens(logits, S.prng_key(seed, "cpu"), torch.ones(1), torch.tensor([0.9]),
                              torch.zeros(1, dtype=torch.int32))
        assert int(out[0]) in (0, 1, 2)


def test_distribution_matches_softmax():
    logits = torch.tensor([[1.0, 0.0, -1.0, 0.5]])
    want = torch.softmax(logits[0], dim=0).numpy()
    n = 4000
    keys = S.split(S.prng_key(42, "cpu"), n)
    one, zero = torch.ones(1), torch.zeros(1, dtype=torch.int32)
    draws = [int(S.sample_tokens(logits, keys[i], one, one, zero)[0]) for i in range(n)]
    freqs = np.bincount(draws, minlength=4) / n
    np.testing.assert_allclose(freqs, want, atol=0.03)


def test_rowkeys_independent_streams():
    """A row's draw depends only on its own key: changing another row's key
    and logits does not change it (continuous-batching reproducibility)."""
    rng = np.random.default_rng(3)
    logits = t(rng.standard_normal((2, 32)), torch.float32)
    keys = S.split(S.prng_key(7, "cpu"), 2)
    temp, top_p, top_k = torch.ones(2), torch.ones(2), torch.zeros(2, dtype=torch.int32)
    t1, k1 = S.sample_tokens_rowkeys(logits, keys, temp, top_p, top_k)
    logits2, keys2 = logits.clone(), keys.clone()
    logits2[1] = t(rng.standard_normal(32), torch.float32)
    keys2[1] = S.prng_key(99, "cpu")
    t2, k2 = S.sample_tokens_rowkeys(logits2, keys2, temp, top_p, top_k)
    assert int(t1[0]) == int(t2[0])
    assert torch.equal(k1[0], k2[0])


@pytest.fixture(scope="module")
def tiny():
    """The port's and JAX's tiny GQA model with the same numpy-drawn weights."""
    tcfg, jcfg, tp, jp = models("tiny-gqa", 0)
    tduo, jduo = duos(tcfg, 2, sink=16, recent=32, chunk=64, max_size=512)
    return tp, tcfg, tduo, jp, jcfg, jduo


def port_engine(tiny):
    tp, tcfg, tduo = tiny[:3]
    return DuoEngine(tp, tcfg, tduo, dtype=torch.float32, device="cpu")


def test_engine_near_greedy_sampling_matches_greedy(tiny):
    eng = port_engine(tiny)
    prompt = np.random.default_rng(5).integers(0, 512, (1, 48))
    greedy, _ = eng.generate(prompt, max_new_tokens=8)
    cold, _ = eng.generate(prompt, max_new_tokens=8, sampling=SamplingParams(temperature=1e-4, top_p=1.0, seed=3))
    np.testing.assert_array_equal(greedy, cold)
    zero, _ = eng.generate(prompt, max_new_tokens=8, sampling=SamplingParams(temperature=0.0, seed=3))
    np.testing.assert_array_equal(greedy, zero)  # temperature 0 takes the greedy path


def test_engine_sampling_reproducible_and_varies(tiny):
    eng = port_engine(tiny)
    prompt = np.random.default_rng(6).integers(0, 512, (1, 32))
    sp = SamplingParams(temperature=1.5, top_p=0.95, seed=11)
    a, _ = eng.generate(prompt, max_new_tokens=12, sampling=sp)
    b, _ = eng.generate(prompt, max_new_tokens=12, sampling=sp)
    np.testing.assert_array_equal(a, b)  # same seed -> same trajectory
    c, _ = eng.generate(prompt, max_new_tokens=12, sampling=SamplingParams(temperature=1.5, top_p=0.95, seed=12))
    assert not np.array_equal(a, c)  # another seed -> another draw


def test_engine_sampled_streams_match_jax(tiny):
    """DuoEngine.generate(sampling=...) for seeds 0-7 (bursts of 4: the
    first token, a split per burst and one per step) gives the JAX engine's
    tokens."""
    tp, tcfg, tduo, jp, jcfg, jduo = tiny
    eng = DuoEngine(tp, tcfg, tduo, batch_size=2, dtype=torch.float32, device="cpu", decode_burst=4)
    jeng = JDuoEngine(jp, jcfg, jduo, batch_size=2, dtype=jnp.float32, attn_impl="ref", decode_burst=4)
    prompt = np.random.default_rng(9).integers(0, 512, (2, 40))
    for seed in range(8):
        sp = SamplingParams(temperature=1.2, top_p=0.95, top_k=(0, 50)[seed % 2], seed=seed)
        jsp = jsampling.SamplingParams(sp.temperature, sp.top_p, sp.top_k, sp.seed)
        want, _ = jeng.generate(prompt, max_new_tokens=10, sampling=jsp)
        got, _ = eng.generate(prompt, max_new_tokens=10, sampling=sp)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"seed {seed}")


def test_serving_mixed_greedy_and_sampled(tiny):
    """Per-request streams make serving reproducible; the greedy row equals
    the single-request engine; every request's tokens equal the JAX
    ServingEngine's."""
    tp, tcfg, tduo, jp, jcfg, jduo = tiny
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, (40 + 7 * i,)) for i in range(3)]
    spec = [None, (1.2, 0.9, 0, 21), (0.0, 1.0, 0, 0)]  # greedy; sampled; explicit greedy (temp 0)

    def run(engine, request, params_cls):
        for i, (p, s) in enumerate(zip(prompts, spec)):
            engine.submit(request(i, p, 6, sampling=None if s is None else params_cls(*s)))
        return {r.rid: list(map(int, r.generated)) for r in engine.run()}

    out1 = run(ServingEngine(tp, tcfg, tduo, max_batch_size=2, dtype=torch.float32, device="cpu"),
               Request, SamplingParams)
    out2 = run(ServingEngine(tp, tcfg, tduo, max_batch_size=2, dtype=torch.float32, device="cpu"),
               Request, SamplingParams)
    assert out1 == out2
    g, _ = port_engine(tiny).generate(prompts[0][None], max_new_tokens=6)
    assert out1[0] == list(g[0])
    want = run(JServingEngine(jp, jcfg, jduo, max_batch_size=2, dtype=jnp.float32, attn_impl="ref"),
               JRequest, jsampling.SamplingParams)
    assert out1 == want
