#!/usr/bin/env python3
"""Which device records torch.profiler loses, and whether a pre-roll keeps them.

    python3 scripts/profiler_first_launches.py      # on one GPU

Launches ten chunks of 3,000 tiny in-place kernels, a different operation a
chunk, under torch.profiler (CPU and CUDA activities), and counts the device
records of each chunk: as profiled from the start, and with
chip_smoke.py's pre-roll (tiny kernels before a marked range, and only the
range read). Four trials each. Prints the card's name and power limit, then
one line a trial: host launch calls, device records, and the chunks that lost
records. Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys

OPS = ("neg_", "abs_", "sqrt_", "exp_", "sin_", "cos_", "floor_", "ceil_", "tanh_", "sigmoid_")
CHUNK, PREROLL, WINDOW = 3000, 10000, "window"


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    x = torch.ones(64, device="cuda")
    scratch = torch.zeros(1, device="cuda")

    def work():
        for op in OPS:
            for _ in range(CHUNK):
                getattr(x, op)()
            x.fill_(1.0)

    def tally(events, start):
        events = [e for e in events if e.time_range.start >= start and e.name != WINDOW]
        host = sum(e.device_type != DeviceType.CUDA and e.name == "cudaLaunchKernel" for e in events)
        device = [e.name.lower() for e in events if e.device_type == DeviceType.CUDA]
        seen = dict.fromkeys(OPS, 0)
        for name in device:  # a record is its first operation by name
            op = next((op for op in OPS if op.rstrip("_") in name), None)
            if op:
                seen[op] += 1
        return host, len(device), {op: CHUNK - n for op, n in seen.items() if n != CHUNK}

    work()
    torch.cuda.synchronize()
    for preroll in (False, True):
        for trial in range(4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if preroll:
                    for _ in range(PREROLL):
                        scratch.add_(1.0)
                    torch.cuda.synchronize()
                with record_function(WINDOW):
                    work()
                    torch.cuda.synchronize()
            events = prof.events()
            start = min(e.time_range.start for e in events if e.name == WINDOW) if preroll else 0.0
            host, device, lost = tally(events, start)
            print(f"{'pre-roll' if preroll else 'from the start'} trial {trial}: {host} host launch calls, "
                  f"{device} device records, lost by chunk {lost or 'none'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
