"""Share of the pool's KV bytes that its live rows hold, %, over the
traced decode steps: the ``serve.decode`` spans' ``kv_live_bytes`` (full
heads at each live row's length, streaming heads at sink + recent at most,
at the burst's start) over ``kv_pool_bytes`` (every KV buffer as
allocated), each burst weighted by its steps."""

from port_bench.core import spans


def read(record):
    got = spans.named("serve.decode")
    pool = sum(s.counts["kv_pool_bytes"] * s.counts["steps"] for s in got)
    return 100.0 * sum(s.counts["kv_live_bytes"] * s.counts["steps"] for s in got) / pool if pool else None
