"""Mean live pool slots over the span's decode steps (each burst weighted by
its steps), from the engine's stamps."""

from port_bench.core.readers import decode_bursts


def read(record):
    bursts = decode_bursts(record) if record else []
    steps = sum(b["steps"] for b in bursts)
    return sum(b["live"] * b["steps"] for b in bursts) / steps if steps else None
