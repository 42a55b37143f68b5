"""End-to-end arithmetic on synthetic timelines."""

import pytest

from port_bench.core.timeline import Timeline, percentile, serving_metrics, train_metrics


def steady(n, stall_at=None, stall=0.0):
    """n requests due every 0.1 s from t=1, first token 0.2 s after due,
    then 4 bursts of 16 tokens every 0.32 s; a stall delays every token seen
    after ``stall_at``."""
    lines = {}
    for k in range(n):
        due = 1.0 + 0.1 * k
        tl = Timeline(due)
        for i, (t, m) in enumerate([(due + 0.2, 1)] + [(due + 0.2 + 0.32 * (j + 1), 16) for j in range(4)]):
            if stall_at is not None and t >= stall_at:
                t += stall
            tl.seen.append((t, m))
        lines[k] = tl
    return lines


def test_percentile_interpolates():
    assert percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.9) == pytest.approx(9.1)
    assert percentile([5.0], 0.9) == 5.0


def test_steady_numbers():
    m = serving_metrics(steady(40), 1.0, 6.0)
    assert m["ttft_p90_ms"] == pytest.approx(200.0)
    assert m["tpot_p90_ms"] == pytest.approx(0.32 * 4 * 1e3 / 64)
    assert m["ttft_samples"] == 40
    lines = steady(40)
    inside = sum(n for tl in lines.values() for t, n in tl.seen if 1.0 <= t <= 6.0)
    assert inside < 40 * 65 and m["output_tokens_per_s"] == pytest.approx(inside / 5.0)


def test_tpot_leaves_out_the_first_sightings_tokens():
    """Two bursts of 16 a step of 0.3 s apart: the interval holds the 16
    tokens of the second burst, not those of the first."""
    tl = Timeline(0.5)
    tl.seen = [(1.0, 16), (1.3, 16)]
    assert serving_metrics({0: tl}, 0.0, 2.0)["tpot_p90_ms"] == pytest.approx(300.0 / 16)
    tl.seen = [(1.0, 17), (1.3, 16), (1.6, 16)]  # the prefill's token rides with the first burst
    assert serving_metrics({0: tl}, 0.0, 2.0)["tpot_p90_ms"] == pytest.approx(600.0 / 32)


def test_a_stall_raises_ttft():
    calm = serving_metrics(steady(40), 1.0, 8.0)
    stalled = serving_metrics(steady(40, stall_at=3.0, stall=1.5), 1.0, 8.0)
    assert stalled["ttft_p90_ms"] > calm["ttft_p90_ms"] + 1000
    assert stalled["tpot_p90_ms"] > calm["tpot_p90_ms"]


def test_unanswered_requests_count_at_their_wait():
    lines = steady(10)
    for k in range(10, 20):  # due but never answered
        lines[k] = Timeline(1.0 + 0.1 * k)
    m = serving_metrics(lines, 1.0, 5.0)
    assert m["ttft_samples"] == 20
    waits = sorted([200.0] * 10 + [(5.0 - (1.0 + 0.1 * k)) * 1e3 for k in range(10, 20)])
    assert m["ttft_p90_ms"] == pytest.approx(percentile(waits, 0.9))
    assert m["ttft_p90_ms"] > 2000


def test_only_window_tokens_and_dues_count():
    lines = steady(40)
    m = serving_metrics(lines, 2.0, 3.0)
    due_inside = [tl for tl in lines.values() if 2.0 <= tl.due < 3.0]
    assert m["ttft_samples"] == len(due_inside) == 10
    inside = sum(n for tl in lines.values() for t, n in tl.seen if 2.0 <= t <= 3.0)
    assert m["output_tokens_per_s"] == pytest.approx(inside / 1.0)


def test_train_tokens_over_the_window():
    steps = [(10.0, 12.0, 2048), (12.0, 15.0, 4096), (15.0, 17.5, 3072)]
    m = train_metrics(steps, 10.0)
    assert m["train_tokens_per_s"] == pytest.approx((2048 + 4096 + 3072) / 7.5)
