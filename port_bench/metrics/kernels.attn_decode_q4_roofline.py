"""The INT4 full-head decode attention kernel's share of its byte roofline,
%: the K and V rows each active row needs at its actual length (never the
bucket, never a freed slot) in the INT4 cache, packed nibbles with their
bf16 scales and zero points, with q and out, over 3.35 TB/s, divided by the
device time of ``full_cache_attention_q4.decode``."""

from port_bench.core import counts_quant, trace
from port_bench.core.profile import _bound
from port_bench.core.readers import decode_bursts, step_lengths


def read(record):
    if not record or "iters" not in record:
        return None
    ms = trace.device_ms(record["trace"]["device"], "full_cache_attention_q4.decode")
    if ms <= 0:
        return None
    nbytes = sum(counts_quant.decode_attn_q4_bytes(record["model"], ls) for b in decode_bursts(record)
                 for ls in step_lengths(b))
    return 100.0 * _bound(0.0, nbytes)[0] / ms
