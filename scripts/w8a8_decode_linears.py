#!/usr/bin/env python3
"""The W8A8 decode linears as a tree's model runs them, weights cold.

    python3 scripts/w8a8_decode_linears.py [ROOT] [--tag NAME]   # on one GPU

Imports ``duo_attention_tpu_torch`` from ROOT (default: this repo), so one
call can time two checkouts, such as a change and its parent, side by side.
Each case is one projection of the 8B model's decode step from bf16 x at
M = 1, 4 and 8, called as the tree's ``models/llama.py`` calls it: where the
tree has ``quant.w8a8_linear_group``, the group in one call (wq+wk+wv,
gate+up); otherwise ``quant.w8a8_linear`` once a weight, each quantizing x
itself. The weights are cold: each call finds them outside the 50 MB L2, as
a decode step does, by rotating over copies (at least 256 MB in all) inside
one captured CUDA graph. Each case runs twice: x drawn from a normal
distribution, and "ties": the same x with each row scaled so its absmax is
7.9375 = 127/16, which makes the scale 1/16 and puts many quotients x / scale
of bf16 values exactly on half-integers, where a kernel that rounds the
product by the reciprocal has to check the division. Every case is held
bitwise to the tree's plain version first. Prints the card's name and power
limit, one row a case (device ms of one call, the mean of two runs, and the
byte bound: weights, x, scales and outputs once at 3.35 TB/s) and the sum
over one decode step at M = 1 from the normal x (32 layers' wq+wk+wv, wo,
gate+up and down, and the head). Writes
chiprun_out/w8a8_decode_linears_<NAME>.json in this repo. Needs a card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
LAYERS = 32
# (name, output widths, K, calls a decode step)
CASES = [("wq+wk+wv", (4096, 1024, 1024), 4096, LAYERS), ("wo", (4096,), 4096, LAYERS),
         ("gate+up", (14336, 14336), 4096, LAYERS), ("down", (4096,), 14336, LAYERS), ("head", (128256,), 4096, 1)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=str(REPO))
    ap.add_argument("--tag", default="run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from duo_attention_tpu_torch.ops import quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    grouped = hasattr(quant, "w8a8_linear_group")
    print(f"{quant.__file__}: {'one call a group' if grouped else 'one w8a8_linear a weight'}")

    def linears(x, weights, out_dtype):
        if grouped:
            return list(quant.w8a8_linear_group(x, weights, out_dtype))
        return [quant.w8a8_linear(x, wq, ws, out_dtype) for wq, ws in weights]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rows, step_ms, step_bound = {}, 0.0, 0.0
    print("case          M  device ms   bound ms")
    for label, ns, K, per_step in CASES:
        out_dtype = torch.float32 if label == "head" else torch.bfloat16
        n_copies = max(2, -(-(256 << 20) // (sum(ns) * K)))
        copies = [[(torch.randint(-127, 128, (n, K), generator=gen, device=dev, dtype=torch.int8),
                    torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4) for n in ns]
                  for _ in range(n_copies)]
        for M in (1, 4, 8):
            x = torch.randn((M, K), generator=gen, device=dev) * 2
            ties = (x * (7.9375 / x.abs().amax(-1, keepdim=True))).to(torch.bfloat16)
            for name, x in (("", x.to(torch.bfloat16)), (" ties", ties)):
                got = linears(x, copies[0], out_dtype)
                want = [quant.w8a8_linear(x, wq, ws, out_dtype, plain=True) for wq, ws in copies[0]]
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    print(f"FAIL: {label} M={M}{name} disagrees with the plain version", file=sys.stderr)
                    return 1

                def calls():
                    for ws in copies:
                        linears(x, ws, out_dtype)

                runs = [cuda_graph_time_ms(calls, calls=2) / n_copies for _ in range(2)]
                nbytes = sum(ns) * K + 2 * M * K + 4 * sum(ns) + M * sum(ns) * (4 if label == "head" else 2)
                row = {"ms": sum(runs) / 2, "runs": runs, "bound_ms": nbytes / PEAK_BYTES * 1e3}
                rows[f"{label} M={M}{name}"] = row
                if M == 1 and not name:
                    step_ms += per_step * row["ms"]
                    step_bound += per_step * row["bound_ms"]
                print(f"{label:12s} {M:2d}  {row['ms']:9.4f}  {row['bound_ms']:9.4f}{name}", flush=True)
        del copies
        torch.cuda.empty_cache()
    rows["step M=1"] = {"ms": step_ms, "bound_ms": step_bound}
    print(f"one decode step at M=1: {step_ms:.4f} ms (bound {step_bound:.4f})")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"w8a8_decode_linears_{args.tag}.json").write_text(json.dumps({"grouped": grouped, "rows": rows},
                                                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
