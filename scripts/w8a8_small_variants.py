#!/usr/bin/env python3
"""The small-M W8A8 kernel's ring, measured at the decode shapes.

    python3 scripts/w8a8_small_variants.py      # on one GPU, from the repo root

Builds edited copies of duo_attention_tpu_torch/csrc/gemm.cu side by side,
each with another slab depth (SM_SLAB: bytes of k a ring stage holds of each
weight row) or ring cap (SM_MAX_RING: the most bytes of stages the kernel
takes beside x), and times ``quant.w8a8_linear_group`` on the card
(w8a8_small_mma_kernel: bf16 x quantized inside the kernel) with its weights
cold: each call finds its weights outside the 50 MB L2, as a decode step
does, by rotating over copies of them (at least 256 MB in all) inside one
captured CUDA graph. The cases are the 8B model's decode groups (wq+wk+wv,
wo, gate+up, down, the head) at M = 1, 2, 4, 8 and 16 (the serving pool's
rows: two 8-row operands a k-step, and the down projection's x in K-chunks);
a variant whose kernel refuses a case shows "-". The first
variant is the source as committed. Every variant is held bitwise to the
plain version once a case. Prints the card's name and power limit and one
row a case: device ms of each variant (the mean of two runs, in turns) and
the byte bound (weights, x, scales and outputs once at 3.35 TB/s). Writes
every run to chiprun_out/w8a8_small_variants.json. Needs nvcc and a card;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PEAK_BYTES = 3.35e12  # H100 SXM HBM3
CASES = [("wq+wk+wv", (4096, 1024, 1024), 4096), ("wo", (4096,), 4096), ("gate+up", (14336, 14336), 4096),
         ("down", (4096,), 14336), ("head", (128256,), 4096)]
SLAB, RING = "constexpr int SM_SLAB = 1024;", "constexpr int SM_MAX_RING = 200000;"
# (name, slab bytes, most ring bytes)
VARIANTS = [("1024 (committed)", 1024, 200_000), ("1024 ring 70 KB", 1024, 70_000), ("2048", 2048, 200_000),
            ("2048 ring 70 KB", 2048, 70_000), ("4096", 4096, 200_000)]


def build_variants(_build, signatures):
    """One library a variant, each from its own edited copy of csrc/."""
    root = _build.BUILD_DIR / "w8a8_small_variants"  # inside the gitignored build directory
    shutil.rmtree(root, ignore_errors=True)
    kept = (_build.CSRC_DIR, _build.BUILD_DIR)
    libs = {}
    try:
        for i, (name, slab, ring) in enumerate(VARIANTS):
            d = root / f"v{i}"
            shutil.copytree(kept[0], d)
            text = (d / "gemm.cu").read_text()
            if SLAB not in text or RING not in text:
                raise SystemExit(f"{name}: gemm.cu no longer holds {SLAB!r} and {RING!r}")
            text = text.replace(SLAB, f"constexpr int SM_SLAB = {slab};")
            (d / "gemm.cu").write_text(text.replace(RING, f"constexpr int SM_MAX_RING = {ring};"))
            _build.CSRC_DIR, _build.BUILD_DIR = d, d / "build"
            _build._loaded.pop("gemm", None)
            libs[name] = _build.load("gemm", signatures)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = kept
        _build._loaded.pop("gemm", None)
    return libs


def main():
    import torch

    from duo_attention_tpu_torch.ops import _build, gemm, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_variants(_build, gemm._SIGNATURES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    print("case          M  bound ms  " + "  ".join(f"{name:>22s}" for name, *_ in VARIANTS))
    try:
        for label, ns, K in CASES:
            out_dtype = torch.float32 if label == "head" else torch.bfloat16
            n_copies = max(2, -(-(256 << 20) // (sum(ns) * K)))
            copies = [[(torch.randint(-127, 128, (n, K), generator=gen, device=dev, dtype=torch.int8),
                        torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4) for n in ns]
                      for _ in range(n_copies)]
            for M in (1, 2, 4, 8, 16):
                x = (torch.randn((M, K), generator=gen, device=dev) * 2).to(torch.bfloat16)
                want = quant.w8a8_linear_group(x, copies[0], out_dtype, plain=True)
                nbytes = sum(ns) * K + 2 * M * K + 4 * sum(ns) + M * sum(ns) * (4 if label == "head" else 2)
                row = {"bound_ms": nbytes / PEAK_BYTES * 1e3}
                runs = {name: [] for name, *_ in VARIANTS}
                for order in (VARIANTS, VARIANTS[::-1]):  # each variant twice, in turns
                    for name, *_ in order:
                        _build._loaded["gemm"] = libs[name]
                        try:
                            got = quant.w8a8_linear_group(x, copies[0], out_dtype)
                            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                                print(f"FAIL: {name} disagrees with the plain version at {label} M={M}",
                                      file=sys.stderr)
                                return 1

                            def calls():
                                for ws in copies:
                                    quant.w8a8_linear_group(x, ws, out_dtype)

                            runs[name].append(cuda_graph_time_ms(calls, calls=2) / n_copies)
                        except RuntimeError:  # the kernel refused: not two stages of this slab
                            pass
                        finally:
                            _build._loaded.pop("gemm", None)
                for name, ms in runs.items():
                    row[name] = sum(ms) / len(ms) if ms else None
                    row[name + " runs"] = ms
                rows[f"{label} M={M}"] = row
                print(f"{label:12s} {M:2d}  {row['bound_ms']:8.4f}  "
                      + "  ".join(f"{row[name]:22.4f}" if row[name] is not None else f"{'-':>22s}"
                                  for name, *_ in VARIANTS), flush=True)
            del copies
            torch.cuda.empty_cache()
    finally:
        _build._loaded.pop("gemm", None)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "w8a8_small_variants.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
