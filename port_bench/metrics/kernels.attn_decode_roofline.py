"""The full-head decode attention kernels' share of their byte roofline, %:
the K and V rows each active row needs at its actual length (never the
bucket, never a freed slot), with q and out, over 3.35 TB/s, divided by the
device time of the kernels the profiler files as
``full_cache_attention.decode`` (the split kernel and its merge)."""

from port_bench.core import counts, trace
from port_bench.core.profile import _bound
from port_bench.core.readers import decode_bursts, step_lengths


def read(record):
    if not record or "iters" not in record:
        return None
    ms = trace.device_ms(record["trace"]["device"], "full_cache_attention.decode")
    if ms <= 0:
        return None
    nbytes = sum(counts.decode_attn_bytes(record["model"], ls) for b in decode_bursts(record)
                 for ls in step_lengths(b))
    return 100.0 * _bound(0.0, nbytes)[0] / ms
