"""RMSNorm with float32 statistics (counterpart of duo_attention_tpu/ops/norm.py).

Plain PyTorch: on the card the reduction and the elementwise chain are a
handful of small launches per layer, far below the projections' cost.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
