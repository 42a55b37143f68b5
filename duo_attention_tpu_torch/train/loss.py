"""Training losses: output-distillation MSE and the L1 gate regularizer.

Counterpart of duo_attention_tpu/train/loss.py. The distillation MSE is
taken per supervised position (mean over the hidden dim), summed and divided
by the supervised-token count; under data and sequence parallelism the sum
and the count are summed over the mesh's axes (the reference's
dist.all_reduce, train.py:131-146), so every rank gets the global value.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..parallel import mesh as pmesh


def l1_loss(gates: torch.Tensor) -> torch.Tensor:
    return gates.abs().mean()


class _GlobalValue(torch.autograd.Function):
    """Forward: the all_reduced ``total``; backward: the gradient goes to the
    rank's own ``local`` term alone, as a sum over ranks of local gradients
    is the global one."""

    @staticmethod
    def forward(ctx, local, total):
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def distill_loss(teacher_hidden: torch.Tensor, student_hidden: torch.Tensor, label_mask: torch.Tensor,
                 axis_names: Optional[Sequence] = None) -> torch.Tensor:
    """MSE over the hidden dim at supervised positions / their count.

    teacher/student: [B, S, E]; label_mask: [B, S] bool (True = supervised).
    ``axis_names``: the mesh axes to sum the supervised sum and count over
    (``Mesh.axis("data")``, ``Mesh.axis("seq")``; one all_reduce an axis of
    more than one rank). The value is then the global loss on every rank,
    and its gradient is this rank's local sum over the global count: the
    caller sums the ranks' gradients (``train/trainer.py``)."""
    diff = teacher_hidden.float() - student_hidden.float()
    per_pos = (diff * diff).mean(dim=-1)
    total = (per_pos * label_mask).sum()
    count = label_mask.sum().float()
    if axis_names:
        both = torch.stack([total.detach(), count])
        for axis in axis_names:
            pmesh.axis_sum(axis, both)
        total, count = _GlobalValue.apply(total, both[0]), both[1]
    return total / torch.clamp(count, min=1.0)
