"""Ulysses sequence parallelism: all_to_all resharding around attention.

Counterpart of duo_attention_tpu/parallel/ulysses.py (itself the
counterpart of the reference's DeepSpeed-Ulysses port,
duo_attn/ulysses/attn_layer.py:15-77 and ulysses/utils.py:14-230): each rank
holds a sequence shard; around each attention the tensors are resharded
seq -> head with an all_to_all over the mesh's seq axis, so every rank
attends over the whole sequence with its share of the heads, and back. As
in the reference (ulysses/utils.py:95-119), each reshard is an autograd
Function whose backward runs the inverse all_to_all (JAX differentiates
``lax.all_to_all`` itself). ``axis`` is the seq axis of a
``parallel.mesh.Mesh`` (``mesh.axis("seq")``); an axis of one rank is the
identity.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import mesh as pmesh


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all`` whose backward is the inverse all_to_all."""

    @staticmethod
    def forward(ctx, x, axis, split_dim: int, concat_dim: int):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return pmesh.all_to_all(axis, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return pmesh.all_to_all(ctx.axis, grad, concat_dim, split_dim), None, None, None


def seq_to_head(x: torch.Tensor, axis) -> torch.Tensor:
    """[B, S/P, H, D] (sequence shard) -> [B, S, H/P, D] (head shard):
    all_to_all_4D's scatter-heads / gather-sequence direction
    (ulysses/utils.py:14-56)."""
    return _AllToAll.apply(x, axis, 2, 1)


def head_to_seq(x: torch.Tensor, axis) -> torch.Tensor:
    """[B, S, H/P, D] -> [B, S/P, H, D], the inverse (ulysses/utils.py:57-92)."""
    return _AllToAll.apply(x, axis, 1, 2)


def ulysses_attention(attn_fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis) -> torch.Tensor:
    """``attn_fn(q, k, v)`` with seq <-> head resharding around it.

    q [B, S/P, Hq, D]; k/v [B, S/P, Hkv, D]. P must divide both Hq and Hkv,
    as JAX's and the reference's require (ulysses/attn_layer.py), so that a
    rank's query heads are the G of each of its KV heads. attn_fn sees
    whole-sequence, head-sharded tensors and returns [B, S, Hq/P, D]."""
    P = axis.size
    if q.shape[2] % P or k.shape[2] % P:
        raise ValueError(f"Ulysses over {P} ranks needs Hq ({q.shape[2]}) and Hkv ({k.shape[2]}) divisible by {P}")
    out = attn_fn(seq_to_head(q, axis), seq_to_head(k, axis), seq_to_head(v, axis))
    return head_to_seq(out, axis)


def roundtrip(mesh, x, w) -> tuple:
    """The reshards on this rank of a mesh with a seq axis, from global
    numpy arrays x and w [B, S, H, D]: seq_to_head of the rank's sequence
    shard of x, head_to_seq of that, and the gradient that the backward of
    seq_to_head gives the shard from ``sum(y * w_r)``, w_r the rank's head
    shard of w (the inverse all_to_all: the rank's sequence shard of w)."""
    axis = mesh.axis("seq")
    S, H = x.shape[1] // axis.size, x.shape[2] // axis.size
    xs = torch.as_tensor(x[:, axis.rank * S : (axis.rank + 1) * S], device=mesh.device).requires_grad_(True)
    y = seq_to_head(xs, axis)
    z = head_to_seq(y, axis)
    (y * torch.as_tensor(w[:, :, axis.rank * H : (axis.rank + 1) * H], device=mesh.device)).sum().backward()
    return y.detach().cpu().numpy(), z.detach().cpu().numpy(), xs.grad.cpu().numpy()
