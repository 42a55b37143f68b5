"""Training losses: output-distillation MSE and the L1 gate regularizer.

Counterpart of duo_attention_tpu/train/loss.py on one device. The
distillation MSE is taken per supervised position (mean over the hidden
dim), summed and divided by the supervised-token count. The JAX version's
``axis_names`` (the count summed over the mesh axes) comes with the parallel
layouts (ROADMAP.md §1 item 8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def l1_loss(gates: torch.Tensor) -> torch.Tensor:
    return gates.abs().mean()


def distill_loss(teacher_hidden: torch.Tensor, student_hidden: torch.Tensor, label_mask: torch.Tensor,
                 axis_names: Optional[Sequence[str]] = None) -> torch.Tensor:
    """MSE over the hidden dim at supervised positions / their count.

    teacher/student: [B, S, E]; label_mask: [B, S] bool (True = supervised)."""
    if axis_names:
        raise NotImplementedError("the count over mesh axes comes with the parallel layouts "
                                  "(ROADMAP.md §1 item 8)")
    diff = teacher_hidden.float() - student_hidden.float()
    per_pos = (diff * diff).mean(dim=-1)
    total = (per_pos * label_mask).sum()
    count = label_mask.sum().float()
    return total / torch.clamp(count, min=1.0)
