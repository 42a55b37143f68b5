"""Model FLOPs utilization of the admission chunks, %: their model
operations (the valid tokens' parameters, causal attention on full heads,
sink + window on streaming heads, the head once a chunk) over the chunks'
seconds x 989 TFLOP/s."""

from port_bench.core import counts
from port_bench.core.profile import PEAK_BF16_FLOPS
from port_bench.core.readers import admit_chunks


def read(record):
    chunks = admit_chunks(record) if record else []
    seconds = sum(a["seconds"] for a in chunks)
    if seconds <= 0:
        return None
    ops = sum(counts.prefill_chunk_flops(record["model"], a["start"], a["tokens"]) for a in chunks)
    return 100.0 * ops / (seconds * PEAK_BF16_FLOPS)
