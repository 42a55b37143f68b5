#!/usr/bin/env python3
"""What paces the INT4 prefill kernel: its producer or its consumers.

    python3 scripts/q4_prefill_variants.py      # on one GPU, from the repo root

Builds edited copies of duo_attention_tpu_torch/csrc/flash_q4.cu side by
side and times full_cache_attention_q4 at the main path's prefill shape (B=1,
S=4096, 4 KV heads, 4 query heads each, cs=12288, bucket 16384) on the
device alone (CUDA-graph replay), in two rounds of alternating order:
  * as committed;
  * the producer's register split (`setmaxnreg`) and unroll of its unpack
    loop changed;
  * "no unpack": the producer leaves the bf16 stages as they are, so the
    consumers run alone; its output is wrong and only its time counts.
Prints ptxas' spill line for each build, each time and whether the output is
within flash.kernel_tolerance_q4 of the plain version, and the card's name
and power limit. Needs nvcc and a card; imports nothing of JAX.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

UNROLL = "#pragma unroll 4\n      for (int u = 0; u < 4; ++u) {\n        const int i = ptid + 128 * u, r = i >> 3, p = i & 7;"
DEC, INC = "setmaxnreg.dec.sync.aligned.u32 72;", "setmaxnreg.inc.sync.aligned.u32 216;"


def split(producer, consumers, unroll):
    return [(DEC, f"setmaxnreg.dec.sync.aligned.u32 {producer};"),
            (INC, f"setmaxnreg.inc.sync.aligned.u32 {consumers};"),
            (UNROLL, UNROLL.replace("unroll 4", f"unroll {unroll}"))]


VARIANTS = {
    "committed (216/72, unroll 4)": [],
    "232/40, unroll 1": split(40, 232, 1),
    "224/56, unroll 2": split(56, 224, 2),
    "no unpack (consumers alone)": [
        ("unpack_tile(packed, base + K_OFF + buf * TILE_BYTES);", ";"),
        ("unpack_tile(packed + PACK_BYTES, base + V_OFF + buf * TILE_BYTES);", ";")],
}


def main():
    import torch

    from duo_attention_tpu_torch.ops import _build, flash, quant
    from duo_attention_tpu_torch.utils import cuda_graph_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    root = _build.BUILD_DIR / "q4_variants"  # inside the gitignored build directory
    shutil.rmtree(root, ignore_errors=True)
    dirs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = root / f"v{i}"
        shutil.copytree(_build.CSRC_DIR, d)
        text = (d / "flash_q4.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (d / "flash_q4.cu").write_text(text)
        dirs[name] = d

    def use(d):
        _build.CSRC_DIR, _build.BUILD_DIR = d, d / "build"
        _build._loaded.clear()

    for name, d in dirs.items():
        use(d)
        lib = _build.build(["flash_q4"])["flash_q4"]
        lines = lib.with_suffix(".log").read_text().splitlines()
        at = next(i for i, line in enumerate(lines) if "Compiling entry" in line and "prefill_q4" in line)
        print(f"{name}: {next(line for line in lines[at:] if 'spill' in line).strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, Hkv, G, T, cs, bucket = 1, 4096, 4, 4, 32768, 12288, 16384
    q = (torch.randn(B, S, Hkv * G, 128, generator=gen, device=dev) * 4).bfloat16()
    kq, ks = quant.quantize_int4_paired(torch.randn(B, Hkv, T, 128, generator=gen, device=dev).bfloat16())
    vq, vs = quant.quantize_int4_paired(torch.randn(B, Hkv, T, 128, generator=gen, device=dev).bfloat16())
    bufs = [t.contiguous() for t in (kq, ks, vq, vs)]
    cs_t = torch.tensor(cs, dtype=torch.int32, device=dev)
    want = flash.full_cache_attention_q4_plain(q, *bufs, cs_t, bucket=bucket)
    names = list(dirs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            use(dirs[name])
            call = lambda: flash.full_cache_attention_q4(q, *bufs, cs_t, bucket=bucket)  # noqa: E731
            err = (call().float() - want.float()).abs()
            ok = bool((err <= flash.kernel_tolerance_q4(want)).all())
            print(f"  round {rnd} {name:30s} {cuda_graph_time_ms(call):.4f} ms on the device; "
                  f"within kernel_tolerance_q4: {ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
