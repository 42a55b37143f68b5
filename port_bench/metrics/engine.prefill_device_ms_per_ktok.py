"""Device milliseconds of admission prefill per 1,000 prompt tokens: the
``engine.prefill_chunk`` spans' device time over their valid tokens. The
program's own spans, recorded while the profiler ran."""

from port_bench.core import spans


def read(record):
    ms = spans.device_ms("engine.prefill_chunk", "tokens")
    return None if ms is None else 1e3 * ms
