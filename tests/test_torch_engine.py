"""The port's DuoEngine against the JAX package's, on the CPU.

Greedy token streams must be equal to the JAX DuoEngine's (float32, tiny
configs, a prompt crossing a chunk boundary and ending in a partial chunk).
Counterparts of tests/test_model.py:232-302 (bursts, early stop, the burst
plan), the overrun poison, and the device rule: without ``device=`` the
engine and its factories run on the card, so on a host with no GPU they
raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from duo_attention_tpu.engine import DuoEngine as JDuoEngine
from duo_attention_tpu.engine import _burst_plan as j_burst_plan
from duo_attention_tpu_torch import DuoEngine, init_cache, init_params
from duo_attention_tpu_torch.engine import _burst_plan
from test_torch_model import duos, ids_for, models

# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)


def port_engine(tcfg, tp, tduo, **kw):
    return DuoEngine(tp, tcfg, tduo, batch_size=1, dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("split", [(0, 2, 4), (1, 1, 1), (2, 2, 2)])
def test_generate_matches_jax(split):
    tcfg, jcfg, tp, jp = models("tiny-gqa", 4)
    tduo, jduo = duos(tcfg, split)
    ids = ids_for(tcfg, 1, 41, 21)  # chunks of 16, 16 and a partial 9
    want, jc = JDuoEngine(jp, jcfg, jduo, dtype=jnp.float32).generate(ids, max_new_tokens=12)
    got, tc = port_engine(tcfg, tp, tduo).generate(ids, max_new_tokens=12)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(tc.length) == int(jc.length) == 41 + 12


def test_burst_decode_matches_exact():
    """Bursts (4, 4, 2, 1 for 11 steps) give the exact-length decode's tokens
    and cache length."""
    tcfg, _, tp, _ = models("tiny-llama", 5)
    tduo, _ = duos(tcfg, 1, max_size=128)
    ids = ids_for(tcfg, 1, 20, 11)
    want, c_exact = port_engine(tcfg, tp, tduo, decode_burst=0).generate(ids, max_new_tokens=11)
    got, c_burst = port_engine(tcfg, tp, tduo, decode_burst=4).generate(ids, max_new_tokens=11)
    np.testing.assert_array_equal(got, want)
    assert int(c_burst.length) == int(c_exact.length) == 20 + 11


def test_burst_early_stop():
    """With stop ids, decoding ends after the first burst in which every row
    has emitted one; the output keeps its shape, padded with the stop id."""
    tcfg, _, tp, _ = models("tiny-llama", 5)
    tduo, _ = duos(tcfg, 1)
    eng = port_engine(tcfg, tp, tduo, decode_burst=4)
    ids = ids_for(tcfg, 1, 20, 13)
    free_run, _ = eng.generate(ids, max_new_tokens=48)
    stop = int(free_run[0, 1])  # in the first burst
    tokens, cache = eng.generate(ids, max_new_tokens=48, stop_token_ids=[stop])
    assert tokens.shape == (1, 48)
    first = int(np.argmax(tokens[0] == stop))
    np.testing.assert_array_equal(tokens[0, : first + 1], free_run[0, : first + 1])
    assert (tokens[0, first + 1 :] == stop).all()
    assert int(cache.length) < 20 + 48


def test_decode_step_predicts_the_next_generated_token():
    tcfg, _, tp, _ = models("tiny-gqa", 4)
    tduo, _ = duos(tcfg, (0, 2, 4))
    eng = port_engine(tcfg, tp, tduo)
    ids = ids_for(tcfg, 1, 41, 21)
    tokens, _ = eng.generate(ids, max_new_tokens=2)
    cache, _ = eng.prefill(ids)
    nxt, cache = eng.decode_step(cache, torch.as_tensor(tokens[:, 0]).long(), length=41)
    assert int(nxt[0]) == int(tokens[0, 1]) and int(cache.length) == 42


def test_burst_plan_properties():
    """Exact total, entries bounded by the burst, at most 1 + log2(burst)
    distinct lengths, and the same plan as the JAX engine."""

    @settings(max_examples=300, deadline=None)
    @given(st.integers(0, 1024), st.integers(-3, 5000))
    def check(burst, n):
        plan = _burst_plan(burst, n)
        assert plan == j_burst_plan(burst, n)
        assert sum(plan) == max(n, 0)
        if n > 0 and burst > 0:
            assert all(0 < p <= burst for p in plan)
            assert len(set(plan)) <= 1 + burst.bit_length()

    check()


@pytest.mark.parametrize("cap", [128, 512, 4096, 1 << 20])
def test_one_bucket_rule_matches_jax(cap):
    """The port's one bucket rule is the JAX engine's (its ``_next_bucket``
    capped at max_cache_size) at every length up to 4,100 and around every
    power of two, and DuoEngine and PipelinedEngine read it."""
    from duo_attention_tpu.engine import _next_bucket as j_next_bucket
    from duo_attention_tpu_torch.engine import bucket_for_length
    from duo_attention_tpu_torch.parallel.pipeline import PipelinedEngine

    tcfg, _, tp, _ = models("tiny-llama", 6)
    tduo, _ = duos(tcfg, 1, max_size=cap)
    engines = (port_engine(tcfg, tp, tduo), PipelinedEngine(tp, tcfg, tduo, devices=["cpu"], dtype=torch.float32))
    lengths = set(range(4101)) | {(1 << k) + d for k in range(1, 23) for d in (-1, 0, 1)}
    for n in sorted(lengths):
        want = min(j_next_bucket(n), cap)
        assert bucket_for_length(n, cap) == want, n
        assert all(e.bucket_for(n) == want for e in engines), n


def test_overrun_poison():
    """Decoding past max_cache_size clamps the full-cache writes, so every
    token of the burst that overran comes back as -1."""
    tcfg, _, tp, _ = models("tiny-llama", 6)
    tduo, _ = duos(tcfg, 1, max_size=128)
    eng = port_engine(tcfg, tp, tduo, decode_burst=8)
    ids = ids_for(tcfg, 1, 124, 3)
    cache, logits = eng.prefill(ids)
    tokens, cache = eng.decode_tokens(cache, torch.argmax(logits, -1), 12, length=124)
    assert int(cache.length) == 136
    assert (tokens[:, :8] == -1).all() and (tokens[:, 8:] == -1).all()
    with pytest.raises(ValueError, match="exceeds max_cache_size"):
        eng.generate(ids, max_new_tokens=12)


def test_entry_points_default_to_the_card(monkeypatch):
    """No device= means the card: with no GPU present, each entry point
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, _, tp, _ = models("tiny-llama", 6)
    tduo, _ = duos(tcfg, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DuoEngine(tp, tcfg, tduo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(tcfg, tduo, 1)
