"""Share of the traced span's wall time spent in admission chunks (the
engine's own stamps, ``ServingEngine(timing=True)``), %."""

from port_bench.core.readers import admit_chunks


def read(record):
    if not record or "iters" not in record:
        return None
    return 100.0 * sum(a["seconds"] for a in admit_chunks(record)) / record["trace"]["window_s"]
