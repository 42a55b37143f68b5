"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX package stores projections ``[in, out]`` (``x @ W``); the port keeps
PyTorch's ``[out, in]`` (``F.linear``), so every projection and the lm head
are transposed here, and the stacked experts of a Mixtral layer go from
``[X, in, out]`` to ``[X, out, in]``; its router ``moe_gate`` ([hidden, X])
stays as it is, in float32. W8A8 params come across as they are: ``*_q8`` stay
int8 (projections and ``lm_head_q8`` transposed, ``embed_q8`` as it is) and
``*_scale`` stay float32, whatever ``dtype`` the other leaves take. The
result computes the same function as the JAX params it came from (the tests
feed both packages through this).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils import resolve_device

# [in, out] in the JAX tree -> [out, in] here
_TRANSPOSED = frozenset(("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"))
_AS_IS = frozenset(("embed", "final_norm", "input_norm", "post_norm", "bq", "bk", "bv"))
# [X, in, out] -> [X, out, in]: the stacked experts of a MoE layer
_EXPERTS = frozenset(("experts_w_gate", "experts_w_up", "experts_w_down"))
# names that may come as an int8 ``name_q8`` with a float32 ``name_scale``
_QUANTIZABLE = _TRANSPOSED | {"embed"}


def leaf_from_numpy(name: str, arr, device, dtype) -> torch.Tensor:
    """One leaf of a JAX params tree (numpy) as the port's tensor named
    ``name`` on ``device``: copied there as it is, then transposed there where
    the port's layout is the transpose (a large leaf is never transposed on
    the host). ``*_q8`` leaves stay int8, ``*_scale`` leaves and the router
    ``moe_gate`` float32; the others take ``dtype``."""
    arr = np.asarray(arr)
    for suffix, kind in (("_q8", torch.int8), ("_scale", torch.float32)):
        base = name[: -len(suffix)]
        if name.endswith(suffix) and base in _QUANTIZABLE:
            if kind is torch.int8 and arr.dtype != np.int8:
                raise ValueError(f"parameter {name!r} must be int8, got {arr.dtype}")
            t = torch.tensor(arr, dtype=kind, device=device)
            return t.t().contiguous() if kind is torch.int8 and base in _TRANSPOSED else t
    if name == "moe_gate":
        return torch.tensor(arr, dtype=torch.float32, device=device)
    if name not in _TRANSPOSED and name not in _AS_IS and name not in _EXPERTS:
        raise ValueError(f"parameter {name!r} has no counterpart in the port")
    t = torch.tensor(arr, dtype=dtype, device=device)
    if name in _EXPERTS:
        return t.transpose(1, 2).contiguous()
    return t.t().contiguous() if name in _TRANSPOSED else t


def params_from_numpy(tree: Mapping[str, Any], device="cuda", dtype=torch.float32) -> dict:
    """tree: the JAX params pytree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the port's
    params dict on ``device`` in ``dtype``. Like every entry point of the
    port it defaults to the card and raises without one; pass
    ``device="cpu"`` for the plain path."""
    device = resolve_device(device)
    out = {name: leaf_from_numpy(name, arr, device, dtype) for name, arr in tree.items() if name != "layers"}
    out["layers"] = [
        {name: leaf_from_numpy(name, arr, device, dtype) for name, arr in layer.items()}
        for layer in tree["layers"]
    ]
    return out
