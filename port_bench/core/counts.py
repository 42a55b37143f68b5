"""Operations and bytes the work needs, from the sizes alone.

These are what the rooflines and the MFU divide by device or step time. They
count what the inputs need, whatever code does it: attention at each row's
actual length and each head's visible keys (never the bucket, never a
freed slot), a MoE layer's ``top_k`` experts a token (never the experts a
dense dispatch also computes), the head once a prefill chunk (the engine
takes the last position's logits) and once a decoded token. So a later
change that does less work raises a share; none can push it past 100%.

A multiply-add is 2 operations. bf16 elements are 2 bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from .weights import Shape, layer_specs

BF16 = 2


@dataclass(frozen=True)
class Model:
    shape: Shape
    full: Tuple[int, ...]  # full KV heads of each layer
    sink: int
    recent: int

    @classmethod
    def of(cls, conf: dict) -> "Model":
        duo = conf["duo"]
        return cls(Shape.of(conf), tuple(len(h) for h in duo["full_kv_heads"]), duo["sink_size"],
                   duo["recent_size"])

    def layer_params(self, active: bool = True, attention_only: bool = False) -> int:
        """Matrix parameters of one layer a token uses (router included)."""
        s, n = self.shape, 0
        for name, shape, _ in layer_specs(s):
            size = int(np.prod(shape))
            if name.startswith(("w_", "experts_")) and attention_only:
                continue
            if name.startswith("experts_") and active:
                size = size // s.experts * s.top_k
            n += size
        if s.experts and not attention_only:
            n += s.hidden * s.experts
        return n

    @property
    def head_params(self) -> int:
        return self.shape.vocab * self.shape.hidden


def stream_visible(p: np.ndarray, c: np.ndarray, sink: int, recent: int) -> np.ndarray:
    """Keys a streaming head's query at position p, in a chunk that starts at
    c, sees: the sink, and max(sink, c - recent) .. p (the serving cache's
    window as of the chunk's start; decode is a chunk of one, c = p)."""
    lo = np.maximum(sink, c - recent)
    return np.minimum(sink, p + 1) + np.maximum(0, p - lo + 1)


def lambda_visible(p: np.ndarray, sink: int, recent: int) -> np.ndarray:
    """Keys gate training's Λ-mask lets query p see: the sink and the last
    ``recent`` positions (itself included)."""
    lo = np.maximum(sink, p - recent + 1)
    return np.minimum(sink, p + 1) + np.maximum(0, p - lo + 1)


def _attn_flops(m: Model, full_keys: float, stream_keys: float) -> float:
    """QK^T and PV over every layer, given the keys summed over the queries."""
    s, G, D = m.shape, m.shape.groups, m.shape.head_dim
    return sum(4 * D * G * (hf * full_keys + (s.kv_heads - hf) * stream_keys) for hf in m.full)


def prefill_chunk_flops(m: Model, c: int, n: int) -> float:
    """Model operations of a chunk of n prompt tokens from position c."""
    p = np.arange(c, c + n, dtype=np.int64)
    attn = _attn_flops(m, float((p + 1).sum()), float(stream_visible(p, np.full_like(p, c), m.sink,
                                                                        m.recent).sum()))
    return 2.0 * m.layer_params() * m.shape.layers * n + 2.0 * m.head_params + attn


def decode_step_flops(m: Model, lengths: Sequence[int]) -> float:
    """Model operations of one decode step for rows whose tokens sit at
    positions ``lengths`` (the length of each row's cache before it)."""
    p = np.asarray(lengths, dtype=np.int64)
    attn = _attn_flops(m, float((p + 1).sum()), float(stream_visible(p, p, m.sink, m.recent).sum()))
    return len(p) * 2.0 * (m.layer_params() * m.shape.layers + m.head_params) + attn


def prefill_attn_flops(m: Model, c: int, n: int) -> float:
    """The full-head prefill kernel's share: causal QK^T and PV of the full
    query heads for the chunk's n queries from position c."""
    p = np.arange(c, c + n, dtype=np.int64)
    D, G = m.shape.head_dim, m.shape.groups
    return 4.0 * D * G * sum(m.full) * float((p + 1).sum())


def decode_attn_bytes(m: Model, lengths: Sequence[int]) -> float:
    """The full-head decode kernel's share of one step: each row's full-head
    K and V at its actual length (the new row included), its q and out."""
    p = np.asarray(lengths, dtype=np.int64)
    D, G, hf = m.shape.head_dim, m.shape.groups, sum(m.full)
    return float(hf * D * BF16 * (2 * (p + 1).sum() + 2 * G * len(p)))


def decode_matmul_bytes(m: Model) -> float:
    """Every dense projection and the head, read once, bf16 (dense models)."""
    return float(BF16 * (m.layer_params(active=False) * m.shape.layers + m.head_params))


def train_step_flops(m: Model, S: int) -> float:
    """Gate training's model operations for one sequence of S tokens: the
    teacher's forward, the student's forward and the student's backward for
    activations only (no weight gradients; recomputation not counted). The
    first layer's student input has no gradient, so its backward stops at
    the gate mix: its MLP and wo alone."""
    s = m.shape
    p = np.arange(S, dtype=np.int64)
    P = m.layer_params()
    attn_params = m.layer_params(attention_only=True)
    wo = s.hidden * s.heads * s.head_dim
    a_full = 4.0 * s.head_dim * s.heads * float((p + 1).sum())
    a_lam = 4.0 * s.head_dim * s.heads * float(lambda_visible(p, m.sink, m.recent).sum())
    per_layer = (2 * P * S + a_full) + (2 * P * S + a_lam) + (2 * P * S + 2 * a_lam)
    first_bwd = 2.0 * (P - attn_params + wo) * S
    return s.layers * per_layer - (2 * P * S + 2 * a_lam) + first_bwd
