"""Milliseconds of admission prefill per 1,000 prompt tokens: the span's
admission chunks' seconds (each waited for) over their tokens."""

from port_bench.core.readers import admit_chunks


def read(record):
    chunks = admit_chunks(record) if record else []
    tokens = sum(a["tokens"] for a in chunks)
    return 1e6 * sum(a["seconds"] for a in chunks) / tokens if tokens else None
