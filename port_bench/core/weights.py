"""Random model weights made from the run's seed, on the device.

Each layer, and the embedding and head, is drawn from a ``torch.Generator``
of its own (seeded from the run's seed and the layer's index), in bf16, the
type the configurations serve in, in one ``randn`` call a layer. So the
plain reference can make any layer again after the program's state is
freed, bit for bit, without keeping a copy.

The layout is the program's params dict in natural head order (``wq``
[Hq * D, E] and so on, ``[out, in]``; a MoE layer's ``moe_gate`` [E, X]
float32 and its stacked experts). Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

_MASK = (1 << 63) - 1


@dataclass(frozen=True)
class Shape:
    """The sizes the weights need, read from a configuration file."""

    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int  # 0: dense MLP
    top_k: int
    eps: float
    rope_theta: float

    @classmethod
    def of(cls, conf: dict) -> "Shape":
        heads = conf["num_attention_heads"]
        return cls(vocab=conf["vocab_size"], hidden=conf["hidden_size"], inter=conf["intermediate_size"],
                   layers=conf["num_hidden_layers"], heads=heads,
                   kv_heads=conf.get("num_key_value_heads", heads),
                   head_dim=conf.get("head_dim", conf["hidden_size"] // heads),
                   experts=conf.get("num_local_experts", 0), top_k=conf.get("num_experts_per_tok", 2),
                   eps=conf["rms_norm_eps"], rope_theta=conf["rope_theta"])

    @property
    def groups(self) -> int:
        return self.heads // self.kv_heads


def _seed(seed: int, part: int) -> int:
    return (seed * 1_000_003 + part * 7_919 + 1) & _MASK


def layer_specs(s: Shape) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of one layer's bf16 tensors, in draw order."""
    E, D, I = s.hidden, s.head_dim, s.inter
    specs = [("wq", (s.heads * D, E), E**-0.5), ("wk", (s.kv_heads * D, E), E**-0.5),
             ("wv", (s.kv_heads * D, E), E**-0.5), ("wo", (E, s.heads * D), (s.heads * D) ** -0.5)]
    if s.experts:
        X = s.experts
        specs += [("experts_w_gate", (X, I, E), E**-0.5), ("experts_w_up", (X, I, E), E**-0.5),
                  ("experts_w_down", (X, E, I), I**-0.5)]
    else:
        specs += [("w_gate", (I, E), E**-0.5), ("w_up", (I, E), E**-0.5), ("w_down", (E, I), I**-0.5)]
    return specs


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def make_layer(s: Shape, seed: int, li: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights: one bf16 draw for every matrix, cut and scaled,
    then the norms (1 + 0.1 N(0, 1)) and, for MoE, the float32 router."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, li + 1))
    specs = layer_specs(s)
    flat = torch.randn(sum(_numel(shape) for _, shape, _ in specs), generator=gen, device=device,
                       dtype=torch.bfloat16)
    layer, off = {}, 0
    for name, shape, scale in specs:
        n = _numel(shape)
        layer[name] = flat[off : off + n].view(shape).mul(scale)  # a tensor of its own, not a view
        off += n
    del flat
    norms = torch.randn(2 * s.hidden, generator=gen, device=device, dtype=torch.float32)
    layer["input_norm"] = (1.0 + 0.1 * norms[: s.hidden]).to(torch.bfloat16)
    layer["post_norm"] = (1.0 + 0.1 * norms[s.hidden :]).to(torch.bfloat16)
    if s.experts:
        layer["moe_gate"] = torch.randn((s.hidden, s.experts), generator=gen, device=device,
                                        dtype=torch.float32).mul_(s.hidden**-0.5)
    return layer


def make_top(s: Shape, seed: int, device) -> Dict[str, torch.Tensor]:
    """embed [V, E] (0.02 N(0, 1)), lm_head [V, E] and final_norm, bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 0))
    V, E = s.vocab, s.hidden
    flat = torch.randn(2 * V * E, generator=gen, device=device, dtype=torch.bfloat16)
    norm = torch.randn(E, generator=gen, device=device, dtype=torch.float32)
    return {"embed": flat[: V * E].view(V, E).mul(0.02),
            "lm_head": flat[V * E :].view(V, E).mul(E**-0.5),
            "final_norm": (1.0 + 0.1 * norm).to(torch.bfloat16)}


def make_params(s: Shape, seed: int, device) -> dict:
    """Every weight, in the program's params layout (natural head order)."""
    params = make_top(s, seed, device)
    params["layers"] = [make_layer(s, seed, li, device) for li in range(s.layers)]
    return params

