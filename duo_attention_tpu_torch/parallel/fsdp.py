"""FSDP-style sharding of the frozen teacher/student params of gate training.

Counterpart of duo_attention_tpu/parallel/fsdp.py (the reference's FSDP2
wrap, duo_attn/train.py:60-69): only the gates train, but the frozen model
is sharded over every rank of the (data, seq) mesh, flattened data major
(``Mesh.axis("world")``), and a per-layer hook all-gathers one layer right
before it is used (one all_gather of the layer's slices); the gathered copy
is dropped after the layer, so the live weights are params / N plus one
layer. Only ``params["layers"]`` is sharded (about 90% of the bytes at
Llama scale); the embedding table, the head and the final norm stay whole
on every rank.

Each layer leaf is split on its largest dim that N divides, as JAX's
``_shard_dim``; the port's [out, in] layout may pick another dim than JAX's
[in, out] does, and the gathered tensor is the same. int8 weights and their
scales are split and gathered alike. JAX's ``lax.optimization_barrier``
(which stops XLA hoisting every gather to the start) has no counterpart:
eager PyTorch gathers where the hook is called.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import mesh as pmesh


def _shard_dim(shape: Tuple[int, ...], n: int) -> Optional[int]:
    """Largest dim divisible by ``n`` (None if nothing divides)."""
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and (best is None or s > shape[best]):
            best = d
    return best


def param_specs(params: Dict, n_shards: int) -> Dict:
    """The FSDP layout of a param dict: ``specs["layers"][l][key]`` is the dim
    that layer l's leaf is split on over ``n_shards`` ranks (None: kept
    whole); every key outside the layers maps to None (replicated)."""
    specs = {key: None for key in params if key != "layers"}
    specs["layers"] = [{key: (_shard_dim(tuple(t.shape), n_shards) if t.dim() >= 1 else None)
                        for key, t in layer.items()} for layer in params["layers"]]
    return specs


def shard_params(params: Dict, mesh) -> Dict:
    """The rank's FSDP params: every layer leaf that ``param_specs`` splits
    is replaced by the rank's slice (a tensor of its own, so the whole one
    can be freed); everything else is shared with ``params``."""
    world = mesh.axis("world")
    specs = param_specs(params, world.size)
    out = {key: val for key, val in params.items() if key != "layers"}
    out["layers"] = [{key: (t if lspec[key] is None else t.chunk(world.size, lspec[key])[world.rank].clone())
                      for key, t in layer.items()}
                     for layer, lspec in zip(params["layers"], specs["layers"])]
    return out


def make_gather_hook(layer_specs: Dict[str, Optional[int]], mesh):
    """The per-layer hook of ``models.llama.forward_two_way(layer_hook=)``:
    ``layer, deps = hook(layer, deps)`` all-gathers the layer's split leaves
    over every rank (``Mesh.axis("world")``) back to their whole shapes;
    ``deps`` (the streams' hidden states) pass through. ``layer_specs`` is
    one layer's specs (``param_specs(...)["layers"][0]``; every layer has
    the same shapes, as JAX assumes).

    JAX gathers leaf by leaf; here the layer's slices go as one all_gather
    of their bytes (each slice with its split dim first, so a rank's slice
    is one contiguous run), and each leaf is cut back out: the same whole
    tensors, one collective a layer in place of one a leaf."""
    world = mesh.axis("world")
    split = [key for key, dim in layer_specs.items() if dim is not None]

    def hook(layer, deps):
        if not split:
            return layer, deps
        local = [layer[key].movedim(layer_specs[key], 0).contiguous() for key in split]
        sizes = [t.numel() * t.element_size() for t in local]
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in local])
        rows = pmesh.all_gather(world, flat, 0).view(world.size, -1)  # rank-major
        whole, offset = dict(layer), 0
        for key, t, size in zip(split, local, sizes):
            part = rows[:, offset : offset + size].contiguous().view(t.dtype)  # [N, slice numel]
            full = part.view(world.size * t.shape[0], *t.shape[1:]).movedim(0, layer_specs[key])
            whole[key] = full.contiguous()
            offset += size
        return whole, deps

    return hook


def layer_bytes(params: Dict) -> List[int]:
    """Bytes of each layer's leaves as the rank holds them."""
    return [sum(t.numel() * t.element_size() for t in layer.values()) for layer in params["layers"]]
