"""The INT4 full-head prefill attention kernel's share of its operations
roofline, %: causal QK^T and PV of each admission chunk's full query heads
at the chunk's start (the valid tokens only), over 989 TFLOP/s, divided by
the device time of ``full_cache_attention_q4.prefill``."""

from port_bench.core import counts, trace
from port_bench.core.profile import _bound
from port_bench.core.readers import admit_chunks


def read(record):
    if not record or "iters" not in record:
        return None
    ms = trace.device_ms(record["trace"]["device"], "full_cache_attention_q4.prefill")
    chunks = admit_chunks(record)
    if ms <= 0 or not chunks:
        return None
    ops = sum(counts.prefill_attn_flops(record["model"], a["start"], a["tokens"]) for a in chunks)
    return 100.0 * _bound(ops, 0.0)[0] / ms
