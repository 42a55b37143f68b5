"""Device resolution and device-side timing."""

from __future__ import annotations

from typing import Callable

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. A CUDA device with no GPU present raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def cuda_time_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call of fn, from CUDA events around
    ``iters`` back-to-back calls on the current stream (after ``warmup``)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn: Callable[[], object], calls: int = 10, replays: int = 5) -> float:
    """Device milliseconds of one call of fn with the host's launch cost taken
    out: ``calls`` calls of fn (which may launch several kernels) are captured
    into one CUDA graph and the graph is replayed. For kernels so short that
    back-to-back launches from Python measure the host. fn must not copy from
    the host or synchronize."""
    fn()  # builds and loads whatever fn needs, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_ms(graph.replay, iters=replays, warmup=1) / calls
