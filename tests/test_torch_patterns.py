"""The port's patterns module (artifact IO, sparsify, head ordering) against
the JAX package's, on the CPU.

Counterpart of tests/test_patterns.py: each case runs the same inputs through
both packages' functions and asserts equal results (the port keeps its own
copy of this module, which imports no JAX).
"""

import os

import numpy as np
import pytest

from duo_attention_tpu import patterns as jpatterns
from duo_attention_tpu_torch import patterns

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts")


def test_save_load_roundtrip_and_files_match_jax(tmp_path):
    heads = np.random.default_rng(0).uniform(0, 1, (4, 8))
    patterns.save_attn_pattern(str(tmp_path / "port"), heads, sink_size=32, recent_size=128)
    jpatterns.save_attn_pattern(str(tmp_path / "jax"), heads, sink_size=32, recent_size=128)
    for name in sorted(os.listdir(tmp_path / "jax")):
        if name.endswith((".tsv", ".json")):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    loaded, sink, recent = patterns.load_attn_pattern(str(tmp_path / "jax"))
    assert sink == 32 and recent == 128
    np.testing.assert_allclose(loaded, heads, atol=1e-12)


@pytest.mark.parametrize("pattern", ["niah_8b/pattern", "niah_8b/pattern_gt"])
def test_load_the_repos_patterns_as_jax_does(pattern):
    """The patterns tracked in the repo load as JAX loads them."""
    run_dir = os.path.join(ARTIFACTS, pattern)
    heads, sink, recent = patterns.load_attn_pattern(run_dir)
    jheads, jsink, jrecent = jpatterns.load_attn_pattern(run_dir)
    np.testing.assert_array_equal(heads, jheads)
    assert (sink, recent) == (jsink, jrecent) and heads.shape == (32, 8)


@pytest.mark.parametrize("target", [0.0, 0.25, 0.5, 0.75, 1.0, None])
def test_sparsify_matches_jax(target):
    heads = np.random.default_rng(1).uniform(0, 1, (8, 8))
    kw = {"threshold": 0.5} if target is None else {"sparsity": target}
    binary, actual = patterns.sparsify_attention_heads(heads, **kw)
    jbinary, jactual = jpatterns.sparsify_attention_heads(heads, **kw)
    np.testing.assert_array_equal(binary, jbinary)
    assert actual == jactual
    assert set(np.unique(binary)) <= {0.0, 1.0}


def test_sparsify_extremes():
    heads = np.ones((4, 4)) * 0.5
    b0, s0 = patterns.sparsify_attention_heads(heads, sparsity=0.0)
    assert b0.sum() == 16 and s0 == 0.0
    b1, s1 = patterns.sparsify_attention_heads(heads, sparsity=1.0)
    assert b1.sum() == 0 and s1 == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_head_ordering_matches_jax(seed):
    """head_permutation (stable: full heads first), expand_kv_perm,
    num_full_kv_heads_per_layer and reordered_gate_matrix equal JAX's."""
    gates = np.random.default_rng(seed).uniform(0, 1, (3, 6))
    gates[0, :2] = 0.5  # ties at the threshold
    for row in gates:
        perm, nf = patterns.head_permutation(row)
        jperm, jnf = jpatterns.head_permutation(row)
        np.testing.assert_array_equal(perm, jperm)
        assert nf == jnf
        np.testing.assert_array_equal(patterns.expand_kv_perm(perm, 3), jpatterns.expand_kv_perm(jperm, 3))
    binary = (gates > 0.5).astype(float)
    assert patterns.num_full_kv_heads_per_layer(binary) == jpatterns.num_full_kv_heads_per_layer(binary)
    np.testing.assert_array_equal(patterns.reordered_gate_matrix(binary), jpatterns.reordered_gate_matrix(binary))


def test_head_permutation_stable():
    perm, num_full = patterns.head_permutation(np.array([0.1, 0.9, 0.2, 0.8, 0.95, 0.0]))
    assert num_full == 3
    np.testing.assert_array_equal(perm, [1, 3, 4, 0, 2, 5])
    np.testing.assert_array_equal(patterns.expand_kv_perm(np.array([2, 0, 1]), repeats=2), [4, 5, 0, 1, 2, 3])


def test_visualize_head_map(tmp_path):
    out = os.path.join(tmp_path, "map.png")
    patterns.visualize_head_map(np.random.default_rng(0).uniform(size=(8, 4)), out, title="test")
    assert os.path.getsize(out) > 0
