"""Operations and bytes of the W8A8KV4 format's kernels, from the sizes alone.

As ``counts.py``: what the inputs need, at each row's actual length (never
the bucket, never a freed row), so no share built on these can pass 100%.

- INT4 cache: a full head keeps, for each token, D / 2 bytes of packed K
  nibbles and D / 2 of V, and a bf16 scale and zero point for each of K and
  V: D + 8 bytes a token a head. q and out stay bf16.
- W8A8 products: an int8 weight byte per parameter and a float32 scale per
  output channel; a multiply-add is 2 operations.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .counts import BF16, Model
from .weights import layer_specs

INT8, FP32 = 1, 4


def q4_bytes_per_token(m: Model) -> int:
    """K and V of one full head at one position in the INT4 cache."""
    return m.shape.head_dim + 4 * BF16


def decode_attn_q4_bytes(m: Model, lengths: Sequence[int]) -> float:
    """The INT4 full-head decode kernel's share of one step: each row's
    full-head K and V at its actual length (the new row included), with
    their scales and zero points, and its q and out in bf16."""
    p = np.asarray(lengths, dtype=np.int64)
    D, G, hf = m.shape.head_dim, m.shape.groups, sum(m.full)
    return float(hf * (q4_bytes_per_token(m) * (p + 1).sum() + 2 * G * D * BF16 * len(p)))


def projection_weight_bytes(m: Model) -> float:
    """Every int8 decoder projection and the int8 head with their float32
    per-output-channel scales: what one decode step reads of the weights
    (dense models)."""
    s = m.shape
    layer = sum(int(np.prod(shape)) * INT8 + shape[0] * FP32 for _, shape, _ in layer_specs(s))
    return float(layer * s.layers + s.vocab * (s.hidden * INT8 + FP32))


def prefill_projection_ops(m: Model, n: int) -> float:
    """The int8 projection operations of a prefill chunk's n valid tokens
    (the decoder layers' products; the head, on one row, is not a tiled
    product)."""
    return 2.0 * m.layer_params() * m.shape.layers * n
