"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX package stores projections ``[in, out]`` (``x @ W``); the port keeps
PyTorch's ``[out, in]`` (``F.linear``), so every projection and the lm head
are transposed here. W8A8 params come across as they are: ``*_q8`` stay
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
# names that may come as an int8 ``name_q8`` with a float32 ``name_scale``
_QUANTIZABLE = _TRANSPOSED | {"embed"}


def _convert(name: str, arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    for suffix, kind in (("_q8", torch.int8), ("_scale", torch.float32)):
        base = name[: -len(suffix)]
        if name.endswith(suffix) and base in _QUANTIZABLE:
            if kind is torch.int8:
                if arr.dtype != np.int8:
                    raise ValueError(f"parameter {name!r} must be int8, got {arr.dtype}")
                if base in _TRANSPOSED:
                    arr = arr.T
            return torch.tensor(np.ascontiguousarray(arr), dtype=kind, device=device)
    if name in _TRANSPOSED:
        arr = arr.T
    elif name not in _AS_IS:
        raise ValueError(f"parameter {name!r} has no counterpart in this slice of the port")
    return torch.tensor(arr, dtype=dtype, device=device)


def params_from_numpy(tree: Mapping[str, Any], device="cuda", dtype=torch.float32) -> dict:
    """tree: the JAX params pytree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the port's
    params dict on ``device`` in ``dtype``. Like every entry point of the
    port it defaults to the card and raises without one; pass
    ``device="cpu"`` for the plain path."""
    device = resolve_device(device)
    out = {name: _convert(name, arr, device, dtype) for name, arr in tree.items() if name != "layers"}
    out["layers"] = [
        {name: _convert(name, arr, device, dtype) for name, arr in layer.items()}
        for layer in tree["layers"]
    ]
    return out
