"""W8A8 matrix product: int8 x int8 -> int32, scale epilogue fused.

Counterpart of duo_attention_tpu/ops/gemm.py (``w8a8_matmul``) and of what
the JAX package leaves to XLA below M = 256 (``ops/quant.py::
_w8a8_linear_impl``: the activation quantization and ``int8_matmul``). Both
compute the same exact result, so here every M has a kernel of
``csrc/gemm.cu`` for a CUDA tensor: the tiled tensor-core route for M >
``SMALL_M_MAX`` and the small-M route at or below it. The small-M route
takes the high-precision x and quantizes it per row (inside the kernel up to
``QUANTIZE_IN_KERNEL_MAX`` rows, in a launch of its own past them), for one
to three weights that share that x, each weight read once
(``w8a8_small_group``); its int8-input mode serves ``w8a8_matmul`` with
``route="small"``. A shape a kernel does not take raises. For a CPU tensor
the plain version runs. Kernel and plain version agree bitwise: the int32
sum is exact and the epilogue is ``(float(acc) * x_scale) * w_scale`` in
float32.

Counters: ``w8a8_matmul.tiled_launches`` / ``.small_launches`` /
``.quantize_launches`` count kernel launches (a group is one small launch,
and past ``QUANTIZE_IN_KERNEL_MAX`` rows one row quantization besides),
``w8a8_matmul_plain.cuda_calls`` plain calls on CUDA tensors.
``weight_passes(M)`` is how many times the route taken at M rows reads each
weight.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "w8a8_tiled": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "w8a8_small": [_P, _L, _I, _P, _I, *[_P] * 9, *[_I] * 8, _P],
    "w8a8_quantize_rows": [_P, _L, _I, _I, _I, _P, _P, _P],
}
# Largest M the small-M route takes when the wrapper chooses. The route
# sweep at M = 16, Mistral-7B's decode groups from bf16 x as the model calls
# them (scripts/w8a8_decode_linears.py --vocab 32000, device ms, weights cold
# in L2; NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), small / tiled (x
# quantized in plain torch, then a tiled launch a weight): wq+wk+wv 0.0151 /
# 0.1202, wo 0.0119 / 0.0572, gate+up 0.0445 / 0.0995, down 0.0283 / 0.0997,
# head 0.0530 / 0.0860; a step of 32 layers and the head 3.24 / 12.14 ms
# (bound 2.15). Past 16 rows a second row group reads the weights again.
SMALL_M_MAX = 16
SMALL_ROWS = 16  # x rows one row group of the small-M kernel takes; past it a launch reads the weights again
# Most rows the small-M kernel quantizes itself (one 8-row operand). Past
# them every one of its ~132 blocks would quantize all the rows again: at 16
# rows that took a step's products from 3.45 to 4.70 ms (down 0.0291 ->
# 0.0550 ms), so x is quantized once by a launch of its own
# (``quantize_rows``) and the product, its programmatic dependent, takes it
# in int8.
QUANTIZE_IN_KERNEL_MAX = 8
_TILED_ROWS = 128  # x rows a tile of the tiled kernel takes (csrc/gemm.cu BM)
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_X_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

_sm_counts: Dict[int, int] = {}


def _lib():
    return _build.load("gemm", _SIGNATURES)


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


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


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"w8a8: {name} must be a contiguous, 16-byte aligned {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] bfloat16 or float32 on the card (rows 16-byte aligned, any
    row stride) -> (xq [M, K] int8, x_scale [M] float32), bitwise
    ``quant.quantize_act_per_token``, in one launch (a block a row)."""
    M, K = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or M == 0 or K % 16 or x.stride(1) != 1 \
            or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"w8a8 row quantization: x {tuple(x.shape)} {x.dtype} with strides {x.stride()}: it "
                         "takes bfloat16 or float32, K % 16 == 0 and contiguous rows, 16-byte aligned")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.w8a8_quantize_rows(x.data_ptr(), x.stride(0), _X_KINDS[x.dtype], M, K, xq.data_ptr(), xs.data_ptr(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "w8a8_quantize_rows")
    w8a8_matmul.quantize_launches += 1
    return xq, xs


def _launch_small(x: torch.Tensor, x_scale, weights, out_dtype, dependent: bool = False) -> List[torch.Tensor]:
    """One launch of the small-M kernel: x [M, K] int8 (with x_scale [M]) or
    bfloat16/float32, rows 16-byte aligned at any row stride; weights 1-3
    (wq [N_i, K] int8, ws [N_i] float32). Returns the outputs [M, N_i]. One
    block an SM; the kernel sizes its ring of weight stages beside x, staging
    x in K-chunks where it does not fit whole, and refuses a launch whose
    blocks cannot keep their tiles' sums across the chunks. ``dependent``:
    launched as the programmatic dependent of the launch just before it on
    the stream (``quantize_rows``, whose output x is), so its weights start
    streaming while that launch runs."""
    M, K = x.shape
    if not 1 <= len(weights) <= 3 or x.dtype not in _X_KINDS or out_dtype not in _OUT_DTYPES:
        raise ValueError(f"w8a8 small-M route: {len(weights)} weights, x {x.dtype}, output {out_dtype}: it takes "
                         "1-3 weights, int8, bfloat16 or float32 x and bfloat16 or float32 output")
    if (M == 0 or K % 16 or x.stride(1) != 1 or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16):
        raise ValueError(f"w8a8 small-M route: x {tuple(x.shape)} with strides {x.stride()}: the kernel needs "
                         "K % 16 == 0 and contiguous rows, 16-byte aligned")
    for i, (wq, ws) in enumerate(weights):
        _check(f"wq[{i}]", wq, torch.int8, x.device)
        _check(f"ws[{i}]", ws, torch.float32, x.device)
        if wq.dim() != 2 or wq.shape[1] != K or tuple(ws.shape) != (wq.shape[0],) or wq.shape[0] == 0:
            raise ValueError(f"w8a8 small-M route: weight {i} {tuple(wq.shape)} scales {tuple(ws.shape)} for x "
                             f"{tuple(x.shape)}")
    if x.dtype == torch.int8:
        _check("x_scale", x_scale, torch.float32, x.device)
        if x_scale.numel() != M:
            raise ValueError(f"w8a8 small-M route: x_scale {tuple(x_scale.shape)} for x {tuple(x.shape)}")
    ns = [wq.shape[0] for wq, _ in weights]
    outs = [torch.empty((M, n), dtype=out_dtype, device=x.device) for n in ns]
    pad = 3 - len(weights)
    w = [wq.data_ptr() for wq, _ in weights] + [None] * pad
    s = [ws.data_ptr() for _, ws in weights] + [None] * pad
    o = [out.data_ptr() for out in outs] + [None] * pad
    lib = _lib()
    err = lib.w8a8_small(x.data_ptr(), x.stride(0), _X_KINDS[x.dtype],
                         x_scale.data_ptr() if x.dtype == torch.int8 else None, len(weights),
                         *w, *s, *o, *(ns + [0] * pad), M, K, int(out_dtype == torch.float32), _sm_count(x.device),
                         int(dependent), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "w8a8_small")
    w8a8_matmul.small_launches += 1
    return outs


def w8a8_small_group(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     out_dtype=torch.bfloat16) -> List[torch.Tensor]:
    """The fused small-M linear on the card: x [M, K] bfloat16 or float32
    (M <= SMALL_M_MAX; any row stride with 16-byte aligned rows), quantized
    per row exactly as ``quant.quantize_act_per_token``, times each of 1-3
    weights (wq [N_i, K] int8, ws [N_i] float32), each weight read once.
    Up to ``QUANTIZE_IN_KERNEL_MAX`` rows ONE launch, quantizing x inside
    the kernel; past it two: ``quantize_rows``, then the product's int8-input
    mode as its programmatic dependent. Returns [M, N_i] ``out_dtype``
    outputs, bitwise those of the plain version (quantize once,
    ``w8a8_matmul_plain`` each)."""
    if not x.is_cuda:
        raise ValueError("w8a8_small_group runs on CUDA tensors; the plain version is quant.w8a8_linear_group")
    if x.dim() != 2 or x.dtype == torch.int8 or x.shape[0] > SMALL_M_MAX:
        raise ValueError(f"w8a8_small_group: x {tuple(x.shape)} {x.dtype}: it takes [M <= {SMALL_M_MAX}, K] "
                         "bfloat16 or float32")
    if x.shape[0] > QUANTIZE_IN_KERNEL_MAX:
        xq, xs = quantize_rows(x)
        return _launch_small(xq, xs, list(weights), out_dtype, dependent=True)
    return _launch_small(x, None, list(weights), out_dtype)


def w8a8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=torch.bfloat16, route: str = "auto") -> torch.Tensor:
    """xq [M, K] int8, x_scale [M, 1] or [M] float32, wq [N, K] int8
    (``[out, in]``), w_scale [N] float32 -> [M, N] ``out_dtype`` (bfloat16 or
    float32). ``route``: "auto" (by M), or "tiled" / "small" to force one
    kernel (for measuring; the small-M kernel's int8-input mode runs rows past
    ``SMALL_ROWS`` as further row groups)."""
    if not xq.is_cuda:
        return w8a8_matmul_plain(xq, x_scale, wq, w_scale, out_dtype)
    M, K = xq.shape
    N = wq.shape[0]
    x_scale = x_scale.reshape(-1)
    for name, t, dtype in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                           ("x_scale", x_scale, torch.float32), ("w_scale", w_scale, torch.float32)):
        _check(name, t, dtype, xq.device)
    if (tuple(wq.shape) != (N, K) or x_scale.numel() != M or w_scale.numel() != N
            or M == 0 or K % 16 != 0 or out_dtype not in _OUT_DTYPES):
        raise ValueError(f"w8a8_matmul: xq {tuple(xq.shape)} wq {tuple(wq.shape)} x_scale "
                         f"{tuple(x_scale.shape)} w_scale {tuple(w_scale.shape)} -> {out_dtype}: "
                         "the kernel needs K % 16 == 0 and bfloat16 or float32 output")
    if route == "auto":
        route = "small" if M <= SMALL_M_MAX else "tiled"
    if route == "small":
        return _launch_small(xq, x_scale, [(wq, w_scale)], out_dtype)[0]
    if route != "tiled":
        raise ValueError(f"w8a8_matmul: route {route!r}")
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    lib = _lib()
    err = lib.w8a8_tiled(xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                         M, N, K, int(out_dtype == torch.float32), torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(lib, err, "w8a8_tiled")
    w8a8_matmul.tiled_launches += 1
    return out


w8a8_matmul.tiled_launches = 0
w8a8_matmul.small_launches = 0
w8a8_matmul.quantize_launches = 0


def weight_passes(M: int) -> int:
    """How many times the products of M rows of x read each int8 weight
    from device memory, on the route ``w8a8_matmul`` and
    ``quant.w8a8_linear_group`` take at M: the small-M kernel once per
    ``SMALL_ROWS`` rows (a row group), the tiled kernel once per 128-row tile."""
    return -(-M // (SMALL_ROWS if M <= SMALL_M_MAX else _TILED_ROWS))
