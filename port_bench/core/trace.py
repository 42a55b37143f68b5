"""The traced span, reduced to plain lists that the per-layer readers read.

``reduce`` takes the events of ``profile._profiled_window`` and keeps:

- ``device``: (name, kind, start us, end us) of every device activity, the
  kind by the frozen ``_kernel_kind``;
- ``host``: (name, start us, end us) of every host event (the benchmark's
  own ranges ``bench.*``, the program's operators, the runtime's calls);
- ``steps``: each ``bench.step`` range (one scheduler iteration or one
  training step) with the host time of its first ``cudaGraphLaunch``, if
  any. A serving iteration waits for its admission chunk before it replays
  the decode graph (the chunk's logits or, with the engine's timing on, a
  synchronize), so device work that starts after that launch is decode
  work and device work before it is the chunk's.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from .profile import _kernel_kind

STEP = "bench.step"


def reduce(events, wall_ms: float) -> Dict:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        r = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith("bench."):  # the benchmark's own ranges, which the profiler also draws on the device
            if e.device_type != DeviceType.CUDA:
                host.append(r)
            continue
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, _kernel_kind(e.name), r[1], r[2]))
        else:
            host.append(r)
    device.sort(key=lambda d: d[2])
    host.sort(key=lambda h: h[1])
    t0 = min([h[1] for h in host] + [d[2] for d in device])
    t1 = t0 + wall_ms * 1e3
    launches = sorted(s for n, s, _ in host if n == "cudaGraphLaunch")
    steps = []
    for name, s0, s1 in host:
        if name != STEP:
            continue
        i = bisect.bisect_left(launches, s0)
        g = launches[i] if i < len(launches) and launches[i] <= s1 else None
        steps.append({"s0": s0, "s1": s1, "graph0": g})
    return {"device": device, "host": host, "t0": t0, "t1": t1, "steps": steps,
            "busy_s": busy_us(device) / 1e6, "window_s": wall_ms / 1e3}


def busy_us(device: List[Tuple]) -> float:
    """Microseconds in which at least one device activity ran."""
    total, end = 0.0, float("-inf")
    for _, _, s, e in device:
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def phase_kernels(rec: Dict, phase: str) -> List[Tuple]:
    """Device activities of the span's ``decode`` phases (started at or after
    a step's first graph launch, inside the step) or ``prefill`` phases (the
    rest of each step)."""
    out = []
    for step in rec["steps"]:
        g = step["graph0"]
        for d in rec["device"]:
            if not step["s0"] <= d[2] <= step["s1"]:
                continue
            is_decode = g is not None and d[2] >= g
            if is_decode == (phase == "decode"):
                out.append(d)
    return out


def device_ms(kernels: List[Tuple], kind: str) -> float:
    return sum(e - s for _, k, s, e in kernels if k == kind) / 1e3


def _gaps(rec: Dict) -> List[Tuple[float, float]]:
    gaps, end = [], rec["t0"]
    for _, _, s, e in rec["device"]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if rec["t1"] > end:
        gaps.append((end, rec["t1"]))
    return gaps


def _host_at(rec: Dict, t: float) -> str:
    """The innermost host event running at time t (the latest started)."""
    best = None
    for name, s, e in rec["host"]:
        if s > t:
            break
        if e >= t:
            best = name
    return best or "none"


def breakdown(rec: Dict, top: int = 10) -> Dict:
    """The device's kinds that took most time, and the longest idle gaps
    with the host call running in each (seconds)."""
    kinds: Dict[str, float] = {}
    for _, kind, s, e in rec["device"]:
        kinds[kind] = kinds.get(kind, 0.0) + (e - s) / 1e6
    gaps = sorted(_gaps(rec), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": sorted(([k, v] for k, v in kinds.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[_host_at(rec, (a + b) / 2), (b - a) / 1e6] for a, b in gaps]}


def summary(rec: Dict, top: int = 12) -> str:
    """The device activities that took most time, by name, and the longest
    single ones: for the run's log."""
    names: Dict[str, float] = {}
    for name, _, s, e in rec["device"]:
        names[name[:90]] = names.get(name[:90], 0.0) + (e - s) / 1e3
    longest = sorted(rec["device"], key=lambda d: d[2] - d[3])[:5]
    lines = [f"  {ms:10.3f} ms  {name}" for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:top]]
    lines += [f"  longest: {(e - s) / 1e3:.3f} ms {name[:90]}" for name, _, s, e in longest]
    return f"traced span {rec['window_s']:.3f} s, {len(rec['device'])} device activities, busy {rec['busy_s']:.3f} s\n" \
        + "\n".join(lines)
