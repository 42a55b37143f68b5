"""Operation and byte counts at tiny shapes, against hand-worked values."""

import numpy as np
import pytest

from port_bench.core import counts
from port_bench.core.weights import Shape

TINY = {"vocab_size": 10, "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2, "rms_norm_eps": 1e-5,
        "rope_theta": 1e4, "duo": {"sink_size": 1, "recent_size": 2, "full_kv_heads": [[0], [0, 1]]}}


def model(**kw):
    return counts.Model.of({**TINY, **kw})


def test_parameters():
    m = model()
    # wq 8x8, wk 4x8, wv 4x8, wo 8x8, gate/up 16x8, down 8x16
    assert m.layer_params() == 64 + 32 + 32 + 64 + 3 * 128
    assert m.layer_params(attention_only=True) == 192
    moe = model(num_local_experts=4, num_experts_per_tok=2)
    assert moe.layer_params() == 192 + 2 * 3 * 128 + 8 * 4
    assert moe.layer_params(active=False) == 192 + 4 * 3 * 128 + 8 * 4
    assert m.head_params == 80


def test_visible_keys():
    p = np.arange(6)
    # sink 1, recent 2; decode (c = p): the sink and p-2..p
    assert list(counts.stream_visible(p, p, 1, 2)) == [1, 2, 3, 4, 4, 4]
    # a chunk from 4: the window as of its start, 2..p
    assert list(counts.stream_visible(np.array([4, 5]), np.array([4, 4]), 1, 2)) == [4, 5]
    # the Λ-mask: the sink and the last 2 positions
    assert list(counts.lambda_visible(p, 1, 2)) == [1, 2, 3, 3, 3, 3]


def test_decode_and_prefill_attention():
    m = model()  # D 2, G 2; full heads 1 + 2 = 3; streaming 1 + 0
    # one row at position 5: full keys 6, streaming keys 4 (sink + 3..5)
    attn = 4 * 2 * 2 * (1 * 6 + 1 * 4) + 4 * 2 * 2 * (2 * 6 + 0)
    assert counts.decode_step_flops(m, [5]) == pytest.approx(2 * (2 * m.layer_params() + 80) + attn)
    # the full-head prefill share of a chunk of 2 from 4: keys 5 + 6 per full query head (6 of them)
    assert counts.prefill_attn_flops(m, 4, 2) == pytest.approx(4 * 2 * 6 * 11)
    # bytes: 3 full heads, K and V at 6 rows each, q and out of 2 query heads each, bf16
    assert counts.decode_attn_bytes(m, [5]) == pytest.approx(3 * 2 * 2 * (2 * 6 + 2 * 2))
    assert counts.decode_matmul_bytes(m) == pytest.approx(2 * (2 * m.layer_params() + 80))


def test_prefill_chunk():
    m = model()
    full_keys = 5 + 6
    stream_keys = 4 + 5  # queries 4, 5 in a chunk from 4: sink + 2..p
    attn = 4 * 2 * 2 * (1 * full_keys + 1 * stream_keys) + 4 * 2 * 2 * (2 * full_keys)
    assert counts.prefill_chunk_flops(m, 4, 2) == pytest.approx(2 * m.layer_params() * 2 * 2 + 2 * 80 + attn)


def test_train_step():
    m = model()
    S, P, D, Hq = 4, m.layer_params(), 2, 4
    a_full = 4 * D * Hq * (1 + 2 + 3 + 4)
    a_lam = 4 * D * Hq * (1 + 2 + 3 + 3)
    layer = (2 * P * S + a_full) + (2 * P * S + a_lam) + (2 * P * S + 2 * a_lam)
    first_bwd = 2 * (3 * 128 + 64) * S
    assert counts.train_step_flops(m, S) == pytest.approx(2 * layer - (2 * P * S + 2 * a_lam) + first_bwd)


def test_shape_reads_published_keys():
    s = Shape.of(TINY)
    assert (s.heads, s.kv_heads, s.groups, s.head_dim, s.experts) == (4, 2, 2, 2, 0)
