"""The admission chunks' tiled W8A8 products' share of their operations
roofline, %: the int8 operations of every decoder projection over each
chunk's valid tokens, over 1,979 TOPS, divided by the device time of
``w8a8_matmul.tiled`` in the span's prefill phases (each step's work before
its first graph launch). Dense models."""

from port_bench.core import counts_quant, trace
from port_bench.core.profile import PEAK_INT8_OPS, _bound
from port_bench.core.readers import admit_chunks


def read(record):
    if not record or "iters" not in record or record["model"].shape.experts:
        return None
    ms = trace.device_ms(trace.phase_kernels(record["trace"], "prefill"), "w8a8_matmul.tiled")
    chunks = admit_chunks(record)
    if ms <= 0 or not chunks:
        return None
    ops = sum(counts_quant.prefill_projection_ops(record["model"], a["tokens"]) for a in chunks)
    return 100.0 * _bound(ops, 0.0, PEAK_INT8_OPS)[0] / ms
