"""The decode steps' W8A8 products' share of their byte roofline, %: every
int8 decoder projection and the int8 head read once a step with their
float32 scales, over 3.35 TB/s, divided by the device time of the
``w8a8_matmul.small`` and ``w8a8_matmul.tiled`` kernels of the span's
decode phases (what runs after a step's first graph launch). Dense models."""

from port_bench.core import counts_quant, trace
from port_bench.core.profile import _bound
from port_bench.core.readers import decode_steps


def read(record):
    if not record or "iters" not in record or record["model"].shape.experts:
        return None
    kernels = trace.phase_kernels(record["trace"], "decode")
    ms = trace.device_ms(kernels, "w8a8_matmul.small") + trace.device_ms(kernels, "w8a8_matmul.tiled")
    steps = decode_steps(record)
    if ms <= 0 or not steps:
        return None
    return 100.0 * _bound(0.0, steps * counts_quant.projection_weight_bytes(record["model"]))[0] / ms
