"""The traffic generator: the same seed gives the same requests, another
seed another order of the same sizes and other token ids."""

import numpy as np
import pytest

from port_bench.core import traffic
from port_bench.core.harness import BENCH_DIR, load_json

MIXES = ["longdoc", "decode", "chat"]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = load_json(BENCH_DIR / "traffic" / f"{mix}.json")
    a, b = traffic.serving_stream(m, 2**31 + 77, 32000), traffic.serving_stream(m, 2**31 + 77, 32000)
    for k in (0, 5, m.get("sizes", traffic.SIZES) + 3):
        assert a.prompt_len(k) == b.prompt_len(k) and a.max_new(k) == b.max_new(k)
        assert np.array_equal(a.prompt_ids(k), b.prompt_ids(k))
        if "rate_rps" in m:
            assert a.due(k) == b.due(k)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_same_sizes_other_order(mix):
    m = load_json(BENCH_DIR / "traffic" / f"{mix}.json")
    a, b = traffic.serving_stream(m, 1, 32000), traffic.serving_stream(m, 2**33 + 5, 32000)
    assert sorted(a.prompts) == sorted(b.prompts) and sorted(a.outputs) == sorted(b.outputs)
    assert not np.array_equal(a.prompts, b.prompts)
    assert not np.array_equal(a.prompt_ids(0)[:64], b.prompt_ids(0)[:64])
    assert a.prompts.min() >= m["prompt"]["min"] and a.prompts.max() <= m["prompt"]["max"]
    assert all(0 <= i < 32000 for i in a.prompt_ids(3))
    if "rate_rps" in m:
        assert a.arrivals[-1] == pytest.approx(b.arrivals[-1])
        assert a.arrivals[-1] / len(a.arrivals) == pytest.approx(1 / m["rate_rps"], rel=0.05)
    assert len(a.prompts) == m.get("sizes", traffic.SIZES)


@pytest.mark.parametrize("mix", ["chat", "longdoc"])
def test_the_order_is_not_smoothed(mix):
    """Over many seeds, the arrivals in 5-second bins scatter as a Poisson
    process's counts do (variance about the mean), and the sum of 8
    consecutive prompts varies as that of 8 independent draws would: no
    order that spreads the sizes or gaps evenly."""
    m = load_json(BENCH_DIR / "traffic" / f"{mix}.json")
    streams = [traffic.serving_stream(m, 2**31 + s, 32000) for s in range(40)]
    if "rate_rps" in m:
        bins = np.concatenate([np.bincount((st.arrivals[:-1] // 5.0).astype(int))[:-1] for st in streams])
        assert 0.6 < bins.var() / bins.mean() < 1.5
    n = m["sizes"]
    q = traffic.quantiles(m["prompt"], n).astype(float)
    sums = np.concatenate([st.prompts.reshape(-1, 8).sum(axis=1) for st in streams])
    drawn_without_replacement = np.sqrt((n - 8) / (n - 1))
    assert sums.std() == pytest.approx(q.std() * np.sqrt(8) * drawn_without_replacement, rel=0.2)


@pytest.mark.parametrize("mix", MIXES)
def test_a_run_draws_on_one_set(mix):
    """The stream repeats after ``sizes`` requests: every seed's run, which
    sends about that many, draws on the same sizes."""
    m = load_json(BENCH_DIR / "traffic" / f"{mix}.json")
    st = traffic.serving_stream(m, 12345, 32000)
    n = m["sizes"]
    assert [st.prompt_len(k) for k in range(n)] == [st.prompt_len(k + n) for k in range(n)]
    assert sorted(st.prompt_len(k) for k in range(n)) == list(traffic.quantiles(m["prompt"], n))
    if "rate_rps" in m:
        assert st.due(n + 1) - st.due(1) == pytest.approx(st.arrivals[-1])


def test_quantiles_and_buckets():
    q = traffic.quantiles({"dist": "loguniform", "min": 4096, "max": 28672}, 256)
    assert q[0] >= 4096 and q[-1] <= 28672 and np.all(np.diff(q) >= 0)
    assert np.exp(np.log(q).mean()) == pytest.approx(np.sqrt(4096 * 28672), rel=0.01)
    u = traffic.quantiles({"dist": "uniform", "min": 128, "max": 512}, 256)
    assert u.mean() == pytest.approx(320, rel=0.01)
    assert traffic.buckets(4097, 28672 + 512 + 16, 32768) == [8192, 16384, 32768]
    assert traffic.buckets(1025, 8192 + 512 + 16, 16384) == [2048, 4096, 8192, 16384]
    assert traffic.buckets(129, 2048 + 256 + 16, 32768) == [512, 1024, 2048, 4096]


def test_passkey_lengths_repeat_across_seeds():
    from port_bench.core.passkey import MultiPasskeyDataset, PasskeyDataConfig

    a = MultiPasskeyDataset(PasskeyDataConfig(context_length_min=2048, context_length_max=4096, seed=3))
    b = MultiPasskeyDataset(PasskeyDataConfig(context_length_min=2048, context_length_max=4096, seed=99))
    la = [len(a[i]["input_ids"]) for i in range(8)]
    lb = [len(b[i]["input_ids"]) for i in range(8)]
    assert all(abs(x - y) <= 128 for x, y in zip(la, lb)) and la[0] >= 2048 and max(la) <= 4096 + 128
    assert not np.array_equal(a[0]["input_ids"], b[0]["input_ids"])
    assert np.array_equal(a[1]["input_ids"], a[1]["input_ids"])
    assert (a[0]["labels"] != -100).sum() > 0
