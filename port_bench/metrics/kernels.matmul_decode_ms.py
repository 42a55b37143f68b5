"""Device milliseconds of matrix products a decode step: the ``matmul``
kernels of the span's decode phases (after a step's first graph launch)
over the span's decode steps. On Mixtral mostly the expert products."""

from port_bench.core import trace
from port_bench.core.readers import decode_steps


def read(record):
    if not record or "iters" not in record:
        return None
    steps = decode_steps(record)
    ms = trace.device_ms(trace.phase_kernels(record["trace"], "decode"), "matmul")
    return ms / steps if steps and ms > 0 else None
