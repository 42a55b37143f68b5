"""Host milliseconds a decode step: the span's decode bursts' seconds (each
ends in its tokens' copy to the host) over their steps."""

from port_bench.core.readers import decode_bursts


def read(record):
    bursts = decode_bursts(record) if record else []
    steps = sum(b["steps"] for b in bursts)
    return 1e3 * sum(b["seconds"] for b in bursts) / steps if steps else None
