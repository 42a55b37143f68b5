"""Model FLOPs utilization of gate training's steps, %. A step's count
(``core/counts.py::train_step_flops``) for a sequence of S tokens, per layer:
the teacher's forward, 2 P S + A_full (P the layer's matrix parameters;
A_full = 4 D Hq sum_p (p + 1), causal QK^T and PV); the student's forward,
2 P S + A_lam (A_lam the same over the Λ-mask's visible keys); its backward
for activations only, 2 P S + 2 A_lam (dx of each product, and dQ, dK, dV,
dP of attention; no weight gradient). The first layer's student input has
no gradient, so its backward is its MLP and wo alone. Recomputation
(checkpointed layers and blocks) is not counted. Over the traced steps'
seconds x 989 TFLOP/s."""

from port_bench.core import counts
from port_bench.core.profile import PEAK_BF16_FLOPS


def read(record):
    steps = record.get("train_steps") if record else None
    if not steps:
        return None
    ops = sum(counts.train_step_flops(record["model"], S) for _, S in steps)
    return 100.0 * ops / (sum(t for t, _ in steps) * PEAK_BF16_FLOPS)
