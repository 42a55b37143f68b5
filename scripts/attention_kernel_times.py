#!/usr/bin/env python3
"""Device times of the attention kernels at the 8B main path's shapes, for
comparing two checkouts of the port on one card.

    python3 scripts/attention_kernel_times.py [ROOT] [--tag NAME] [--rounds N]   # on one GPU

Imports ``duo_attention_tpu_torch`` from ROOT (default: this repo), so one
call can time a change and its parent side by side (parent, change, change,
parent). The cases are chip_smoke.py phase 3's main ones at head_dim 128 (4
KV heads, 4 query heads each, B = 1): the bf16 full-head prefill (a 4,096-row
chunk at cs = 12,288) and decode (cs = 16,000, bucket 16,384), the streaming
prefill and decode (sink 64, recent 256, ring 4,608), and the INT4 full-head
prefill and decode, plus the decode at B = 4, and the bf16 full-head decode
at the serving pool's shape (16 rows, 5 live at 4k-28k keys, 11 freed at
stale lengths; hf 1, 4 and 8; bucket 32,768; a tree whose
``full_cache_attention`` takes ``valid`` is told which rows are live, an older
one reads every row). Each case's output is checked (the pool's live rows)
against the tree's plain version with its tolerance first. A time is the
device ms of one call replayed from a CUDA graph (``utils.cuda_graph_time_ms``),
the median of ``--rounds`` rounds. Prints the card's name and power limit and
one row a case; writes chiprun_out/attention_kernel_times_<NAME>.json in this
repo. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D, HKV, G, CHUNK, SINK, RECENT, RING, T = 128, 4, 4, 4096, 64, 256, 4608, 32768


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=str(REPO))
    ap.add_argument("--tag", default="run")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from duo_attention_tpu_torch.ops import flash, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(128)

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * mul).to(torch.bfloat16)

    k, v = randn(4, HKV, T, D), randn(4, HKV, T, D)
    kq, ks = quant.quantize_int4_paired(k)
    vq, vs = quant.quantize_int4_paired(v)
    sink_k, sink_v = randn(4, HKV, SINK + CHUNK, D), randn(4, HKV, SINK + CHUNK, D)
    ring_k, ring_v = randn(4, HKV, RING, D), randn(4, HKV, RING, D)
    cases = {}
    for label, B, S, cs, bucket in (("prefill cs=12288", 1, CHUNK, 12288, 16384), ("decode cs=16000", 1, 1, 16000, 16384),
                                    ("decode cs=16000 B=4", 4, 1, 16000, 16384)):
        q = randn(B, S, HKV * G, D, mul=4.0)
        cs_t = torch.tensor(cs, dtype=torch.int32, device="cuda")
        full = [t[:B].contiguous() for t in (k, v)]
        q4 = [t[:B].contiguous() for t in (kq, ks, vq, vs)]
        stream = [t[:B].contiguous() for t in (sink_k, sink_v, ring_k, ring_v)]
        for name, call, plain, tol in (
                ("full_cache_attention", lambda: flash.full_cache_attention(q, *full, cs_t, bucket=bucket),
                 lambda: flash.full_cache_attention_plain(q, *full, cs_t, bucket=bucket), flash.kernel_tolerance),
                ("streaming_cache_attention",
                 lambda: flash.streaming_cache_attention(q, *stream, cs_t, cs_t + S, SINK, RECENT),
                 lambda: flash.streaming_cache_attention_plain(q, *stream, cs_t, cs_t + S, SINK, RECENT),
                 flash.kernel_tolerance),
                ("full_cache_attention_q4", lambda: flash.full_cache_attention_q4(q, *q4, cs_t, bucket=bucket),
                 lambda: flash.full_cache_attention_q4_plain(q, *q4, cs_t, bucket=bucket), flash.kernel_tolerance_q4)):
            want = plain()
            err = (call().float() - want.float()).abs()
            if not bool((err <= tol(want)).all()):
                print(f"FAIL: {name} {label} disagrees with its plain version ({float(err.max())})", file=sys.stderr)
                return 1
            times = [cuda_graph_time_ms(call) for _ in range(args.rounds)]
            key = f"{name} {label}"
            cases[key] = dict(device_ms=statistics.median(times), rounds=times)
            print(f"  {key:52s} {cases[key]['device_ms']:.4f} ms  (rounds {', '.join(f'{t:.4f}' for t in times)})")
    # the serving pool's shape: live rows from the seed, freed rows at stale lengths
    takes_valid = "valid" in inspect.signature(flash.full_cache_attention).parameters
    B = 16
    live = torch.zeros(B, dtype=torch.int32)
    live[torch.randperm(B, generator=torch.Generator().manual_seed(17))[:5]] = 1
    cs = torch.where(live > 0, torch.randint(4096, 28672, (B,), generator=torch.Generator().manual_seed(18)),
                     torch.randint(0, 2 * T, (B,), generator=torch.Generator().manual_seed(19)))
    cs, live = cs.to(torch.int32).cuda(), live.cuda()
    for hf in (1, 4, 8):
        q = randn(B, 1, hf * G, D, mul=4.0)
        kp, vp = randn(B, hf, T, D), randn(B, hf, T, D)
        kw = dict(bucket=T, valid=live) if takes_valid else dict(bucket=T)
        call = lambda: flash.full_cache_attention(q, kp, vp, cs, **kw)  # noqa: E731
        want = flash.full_cache_attention_plain(q, kp, vp, cs, bucket=T)
        on = live > 0
        err = (call()[on].float() - want[on].float()).abs()
        if not bool((err <= flash.kernel_tolerance(want[on])).all()):
            print(f"FAIL: the pool decode at hf {hf} disagrees with its plain version ({float(err.max())})",
                  file=sys.stderr)
            return 1
        times = [cuda_graph_time_ms(call) for _ in range(args.rounds)]
        key = f"full_cache_attention decode pool B=16 hf={hf}"
        # the live rows' K and V at their lengths, q and out, over 3.35 TB/s
        nbytes = 2 * (2 * B * hf * G * D) + 2 * (2 * hf * D * int((cs[on] + 1).sum()))
        cases[key] = dict(device_ms=statistics.median(times), rounds=times, valid=takes_valid,
                          bound_ms=nbytes / 3.35e12 * 1e3)
        print(f"  {key:52s} {cases[key]['device_ms']:.4f} ms  (rounds {', '.join(f'{t:.4f}' for t in times)}; "
              f"bound {cases[key]['bound_ms']:.4f} ms)")
        del q, kp, vp
    out = REPO / "chiprun_out" / f"attention_kernel_times_{args.tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(root=str(Path(args.root).resolve()), tag=args.tag, nvidia_smi=smi, cases=cases),
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
