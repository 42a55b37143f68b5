"""Every launch counter of the port's kernel wrappers, as one list.

Each wrapper counts its kernel launches in a plain integer attribute (and each
plain version its calls on CUDA tensors), which moves while Python runs the
wrapper. A decode step captured into a CUDA graph runs Python once, at the
capture, and launches nothing then; ``engine.DuoEngine`` takes the counters'
movement during the capture back out with ``add`` and adds it again on every
replay, so the counts stay the kernels' true launches.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def counters() -> Dict[str, Tuple[object, str]]:
    """name -> (function, attribute) of every counter: each kernel's launches
    (by wrapper and route), then each plain version's calls on CUDA tensors."""
    from . import flash, gemm, inplace

    kernels = {
        "full_cache_attention.prefill": (flash.full_cache_attention, "prefill_launches"),
        "full_cache_attention.decode": (flash.full_cache_attention, "decode_launches"),
        "streaming_cache_attention.prefill": (flash.streaming_cache_attention, "prefill_launches"),
        "streaming_cache_attention.decode": (flash.streaming_cache_attention, "decode_launches"),
        "write_row": (inplace.write_row, "launches"),
        "write_streaming_rows": (inplace.write_streaming_rows, "launches"),
        "full_cache_attention_q4.prefill": (flash.full_cache_attention_q4, "prefill_launches"),
        "full_cache_attention_q4.decode": (flash.full_cache_attention_q4, "decode_launches"),
        "write_q4_token": (inplace.write_q4_token, "launches"),
        "w8a8_matmul.tiled": (gemm.w8a8_matmul, "tiled_launches"),
        "w8a8_matmul.small": (gemm.w8a8_matmul, "small_launches"),
    }
    plain = (flash.full_cache_attention_plain, flash.streaming_cache_attention_plain,
             flash.full_cache_attention_q4_plain, inplace.write_row_plain, inplace.write_streaming_rows_plain,
             inplace.write_q4_token_plain, gemm.w8a8_matmul_plain)
    return {**kernels, **{fn.__name__: (fn, "cuda_calls") for fn in plain}}


def snapshot() -> List[int]:
    return [getattr(fn, attr) for fn, attr in counters().values()]


def add(delta: List[int]) -> None:
    for (fn, attr), d in zip(counters().values(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)
