"""W8A8 matrix product: int8 x int8 -> int32, scale epilogue fused.

Counterpart of duo_attention_tpu/ops/gemm.py (``w8a8_matmul``). The JAX
package sends only large M to its Pallas kernel and leaves the rest to XLA;
both compute the same exact result, so here ONE wrapper takes every M. For a
CUDA tensor it launches the hand-written kernel of ``csrc/gemm.cu``: the
tiled tensor-core route for M > ``SMALL_M_MAX`` and the small-M route (one
warp per output column, bound by reading the weights once) at or below it;
a shape neither takes raises. For a CPU tensor it runs the plain version.
Kernel and plain version agree bitwise: the int32 sum is exact and the
epilogue is ``(float(acc) * x_scale) * w_scale`` in float32.

Counters: ``w8a8_matmul.tiled_launches`` / ``.small_launches`` count kernel
launches, ``w8a8_matmul_plain.cuda_calls`` plain calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"w8a8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}
# Largest M the small-M route takes when the wrapper chooses. chip_smoke.py's
# route sweep (device ms, weights cold in L2, small / tiled; NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md): 4096x4096 M=8 0.0126 / 0.0268, M=16 0.0208 /
# 0.0284; 14336x4096 M=8 0.0436 / 0.0352, M=16 0.0808 / 0.0368. Summed over
# a layer's wq, wo, gate, up and down, the small route is ahead at M = 8 and
# behind at 16.
SMALL_M_MAX = 8
_ROUTES = {"tiled": 0, "small": 1}
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    return _build.load("gemm", _SIGNATURES)


def w8a8_matmul_plain(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
                      w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version, exact on the CPU and on the card: the integer sum is
    taken in float64 (|sum| <= K * 127^2 is far below 2^53; int32 matmul has
    no CUDA implementation and float32 is inexact past K = 1040), rounded
    once to float32 as an int32 -> float32 cast rounds, then multiplied by
    x_scale and by w_scale in that order."""
    if xq.is_cuda:
        w8a8_matmul_plain.cuda_calls += 1
    acc = (xq.double() @ wq.double().T).float()
    return ((acc * x_scale.reshape(-1, 1).float()) * w_scale.float()).to(out_dtype)


w8a8_matmul_plain.cuda_calls = 0


def w8a8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16, route: str = "auto") -> torch.Tensor:
    """xq [M, K] int8, x_scale [M, 1] or [M] float32, wq [N, K] int8
    (``[out, in]``), w_scale [N] float32 -> [M, N] ``out_dtype`` (bfloat16 or
    float32). ``route``: "auto" (by M), or "tiled" / "small" to force one
    kernel (for measuring)."""
    if not xq.is_cuda:
        return w8a8_matmul_plain(xq, x_scale, wq, w_scale, out_dtype)
    M, K = xq.shape
    N = wq.shape[0]
    x_scale = x_scale.reshape(-1)
    for name, t, dtype in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                           ("x_scale", x_scale, torch.float32), ("w_scale", w_scale, torch.float32)):
        if t.device != xq.device or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a8_matmul: {name} must be a contiguous, 16-byte aligned {dtype} tensor "
                             f"on {xq.device}, got {t.dtype} on {t.device}")
    if (tuple(wq.shape) != (N, K) or x_scale.numel() != M or w_scale.numel() != N
            or M == 0 or K % 16 != 0 or out_dtype not in _OUT_DTYPES):
        raise ValueError(f"w8a8_matmul: xq {tuple(xq.shape)} wq {tuple(wq.shape)} x_scale "
                         f"{tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)} -> {out_dtype}: "
                         "the kernel needs K % 16 == 0 and bfloat16 or float32 output")
    if route == "auto":
        route = "small" if M <= SMALL_M_MAX else "tiled"
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    lib = _lib()
    err = lib.w8a8_matmul(
        xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        M, N, K, int(out_dtype == torch.float32), _ROUTES[route],
        torch.cuda.current_stream(xq.device).cuda_stream,
    )
    _build.check(lib, err, "w8a8_matmul")
    if route == "small":
        w8a8_matmul.small_launches += 1
    else:
        w8a8_matmul.tiled_launches += 1
    return out


w8a8_matmul.tiled_launches = 0
w8a8_matmul.small_launches = 0
