"""The decode steps' matrix products' share of their byte roofline, %:
every dense projection and the head read once a step in bf16, over 3.35
TB/s, divided by the device time of the ``matmul`` kernels of the span's
decode phases (what runs after a step's first graph launch). A dense model
only: a MoE layer's expert bytes depend on routing the trace does not show."""

from port_bench.core import counts, trace
from port_bench.core.profile import _bound
from port_bench.core.readers import decode_steps


def read(record):
    if not record or "iters" not in record or record["model"].shape.experts:
        return None
    ms = trace.device_ms(trace.phase_kernels(record["trace"], "decode"), "matmul")
    steps = decode_steps(record)
    if ms <= 0 or not steps:
        return None
    return 100.0 * _bound(0.0, steps * counts.decode_matmul_bytes(record["model"]))[0] / ms
