"""The profiler window, the kernels' kinds and the device breakdown.

Copied from ``chip_smoke.py`` at commit abc807a (``PEAK_*`` and ``_bound``
l. 240-242 and 422-424, ``PREROLL_LAUNCHES``/``WINDOW`` l. 305, the launch
and kernel names l. 302-311, ``_profiled_window`` l. 1403-1428,
``_kernel_kind`` l. 1719-1739, ``device_breakdown`` l. 1742-1784) and frozen
here, so that a later change to the program cannot move the yardstick.
Changed only where the copy stands alone: ``require`` raises directly, the
range is named for this harness, and ``device_breakdown`` drops the counts
of launches that only ``chip_smoke.py`` reads.
"""

from __future__ import annotations

import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

FLASH_CU_KERNELS = ("prefill_kernel", "decode_kernel", "decode_merge_kernel", "stream_decode_kernel")  # profiler names
# device_breakdown: tiny kernels launched before the profiled window, and its range's name
PREROLL_LAUNCHES, WINDOW = 10000, "port_bench_window"
# host calls that put work on the device, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _profiled_window(fn):
    """Run fn under torch.profiler (host and device) and return (the events
    from the start of fn's marked range on, the window's wall ms). The
    profiler can lose the device records of the first launches after it
    starts, so PREROLL_LAUNCHES tiny kernels go first and only events from
    the start of the window, a marked range after them, are kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL_LAUNCHES):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # the range on the host (the profiler may also draw it on the device timeline)
    start = min(e.time_range.start for e in events if e.name == WINDOW)
    return [e for e in events if e.time_range.start >= start and e.name != WINDOW], wall_ms


def _kernel_kind(name):
    """The port's kernels by name (prefill_kernel<0, D> is full heads, <1, D>
    streaming; the bf16 full-head decode is a split kernel and its merge),
    cuBLAS matrix products, and everything else."""
    ours = {"prefill_kernel<0,": "full_cache_attention.prefill",  # <MODE, D>
            "prefill_kernel<1,": "streaming_cache_attention.prefill",
            "stream_decode_kernel": "streaming_cache_attention.decode",  # before decode_kernel<, a part of its name
            "decode_kernel<": "full_cache_attention.decode",
            "decode_merge_kernel": "full_cache_attention.decode",
            "write_streaming_rows_kernel": "write_streaming_rows", "write_row_kernel": "write_row",
            "prefill_q4_kernel": "full_cache_attention_q4.prefill",
            "decode_q4_kernel": "full_cache_attention_q4.decode",
            "write_q4_token_kernel": "write_q4_token",
            "w8a8_tiled_kernel": "w8a8_matmul.tiled", "w8a8_small_mma_kernel": "w8a8_matmul.small"}
    compact = name.replace(" ", "")
    for key, kind in ours.items():
        if key in compact:
            return kind
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def device_breakdown(fn):
    """Run fn under torch.profiler: device milliseconds by kind of kernel,
    the window's wall time, and the share of it the device was idle (the
    profiler's own host cost inflates the wall time, so this idle share is
    an upper bound), with the host's launch calls and the device activities
    counted. Read from a marked range behind a pre-roll, as
    ``_profiled_window`` says."""
    from torch.autograd import DeviceType

    events, wall_ms = _profiled_window(fn)
    by_kind, other = {}, {}
    host_calls = device_activities = 0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            host_calls += e.name in HOST_LAUNCH_CALLS
            continue
        device_activities += 1
        ms = e.time_range.elapsed_us() / 1e3
        kind = _kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        if kind == "other":
            if any(k in e.name for k in FLASH_CU_KERNELS):
                raise RuntimeError(f"kernel {e.name!r} of flash.cu is filed under 'other'")
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + ms
    busy = sum(by_kind.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=(1 - busy / wall_ms) if busy else None,
                host_launch_calls=host_calls, device_activities=device_activities,
                by_kind_ms=by_kind, top_other_ms=dict(sorted(other.items(), key=lambda kv: -kv[1])[:6]),
                events=events)
