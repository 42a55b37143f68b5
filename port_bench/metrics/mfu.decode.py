"""Model FLOPs utilization of the decode steps, %: their model operations
(``core/counts.py``: 2 x the parameters a live row uses a token, a MoE layer's
top-k experts only, and attention at each row's actual length and window)
over the decode bursts' seconds x 989 TFLOP/s."""

from port_bench.core.profile import PEAK_BF16_FLOPS
from port_bench.core.readers import decode_bursts, decode_flops


def read(record):
    bursts = decode_bursts(record) if record else []
    seconds = sum(b["seconds"] for b in bursts)
    return 100.0 * decode_flops(record) / (seconds * PEAK_BF16_FLOPS) if seconds > 0 else None
