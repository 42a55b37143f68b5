#!/usr/bin/env python3
"""The INT4 decode kernel's split size, measured at the main path's shapes.

    python3 scripts/q4_decode_splits.py      # on one GPU, from the repo root

Times full_cache_attention_q4 at decode on the device alone (CUDA-graph replay
of 20 calls) at B = 1, cs = 16000, bucket 16384, 2 to 6 full KV heads with 4
query heads each, at B = 4 with 4, and at 4 heads with the query early in its
bucket (cs = 8200 and 1000); for each, splits of 512 to 2048 keys in place of
ops/flash.py's plan (and the plan's own; the kernel takes at most 32 splits a
(sequence, KV head), so 512 keys is the smallest split of a 16384-key bucket).
Every split is also held to flash.kernel_tolerance_q4 against the plain
version. Prints the card's name and power limit and one table row a shape.
Needs nvcc and a card; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SHAPES = [(1, 2, 16000), (1, 3, 16000), (1, 4, 16000), (1, 5, 16000), (1, 6, 16000), (4, 4, 16000),
          (1, 4, 8200), (1, 4, 1000)]  # (B, full KV heads, the query's position)
SPLITS = (512, 768, 1024, 2048)
BUCKET = 16384


def main():
    import torch

    from duo_attention_tpu_torch.ops import flash, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    kept_plan = flash.q4_decode_split_plan
    bad = 0
    try:
        for B, hf, pos in SHAPES:
            kq, ks = quant.quantize_int4_paired(randn(B, hf, BUCKET, 128))
            vq, vs = quant.quantize_int4_paired(randn(B, hf, BUCKET, 128))
            bufs = [t.contiguous() for t in (kq, ks, vq, vs)]
            q = randn(B, 1, 4 * hf, 128, mul=4.0)
            cs = torch.tensor(pos, dtype=torch.int32, device=dev)
            want = flash.full_cache_attention_q4_plain(q, *bufs, cs, bucket=BUCKET)
            plan = kept_plan(BUCKET, B * hf)
            splits = sorted(set(SPLITS) | {plan[1]})
            row = []
            for keys in splits:
                flash.q4_decode_split_plan = lambda span, heads, keys=keys: (-(-span // keys), keys)
                call = lambda: flash.full_cache_attention_q4(q, *bufs, cs, bucket=BUCKET)  # noqa: E731
                err = (call().float() - want.float()).abs()
                ok = bool((err <= flash.kernel_tolerance_q4(want)).all())
                bad += not ok
                row.append(f"{keys} ({-(-BUCKET // keys) * B * hf} blocks) {cuda_graph_time_ms(call, calls=20):.4f}"
                           + ("" if ok else " BAD"))
            flash.q4_decode_split_plan = kept_plan
            print(f"B={B} hf={hf} cs={pos} (plan: {plan[0]} splits of {plan[1]} keys), device ms by split keys: "
                  + ", ".join(row), flush=True)
    finally:
        flash.q4_decode_split_plan = kept_plan
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
