"""Share of the full-head decode kernels' K and V reads spent on freed pool
rows, %: the ``serve.decode`` spans' ``attn_full_dead_bytes`` over their
live and dead bytes. A freed row keeps its device length until its slot is
admitted again, and the kernels read its full-head rows up to it (stopped
at the bucket) at every step; a live row at length n reads n + t + 1
positions at step t. Counted by the program from its host state."""

from port_bench.core import spans


def read(record):
    got = spans.named("serve.decode")
    dead = sum(s.counts["attn_full_dead_bytes"] for s in got)
    total = dead + sum(s.counts["attn_full_live_bytes"] for s in got)
    return 100.0 * dead / total if total else None
