"""The controls of a formatted cell's correctness check (``drivers/
closed_loop_formatted.py``): the program with a part of the format left
out, and the reference computed in a lower precision than the format, each
read against the format's reference.

For each seed the cell runs for ``--seconds`` at its own load and keeps its
sample; the program's reading is the gaps of its served tokens. Then the
sample's prompts and served tokens are fed through each control, and at each
position the token it puts first is read in the references' logits:

- the program (prefill, then one eager decode step a token, as the pool
  decodes) with a part of the format left out: ``w8a8_bf16_kv``, W8A8 over a
  bf16 cache (no INT4); ``bf16_int4_kv``, bf16 weights over the INT4 cache
  (no W8A8); ``bf16``, neither;
- the reference (``reference/w8a8kv4.py``) below the format: ``w4a8kv4``,
  INT4 weights; ``w8a8kv2``, a 2-bit full-head cache; ``w8a8kv4_stream4``,
  the streaming heads' cache in INT4 too. Made by the reference, these
  carry none of the re-roundings a program's bf16 activations add, so they
  lie nearer the format's reference than a program in their precision would.

    python3 port_bench/control_quantized.py --workload <name> --seeds 11,12,13 [--seconds 20]

on the card (it refuses the CPU, as ``run.py`` does). Prints one JSON line a
seed: each side's compared numbers and widest gap, and the ``correct`` that
``harness.check_ok`` gives each side against the cell's limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import harness  # noqa: E402
from port_bench.core.harness import log  # noqa: E402

# name -> (W8A8 weights, an INT4 cache): the program with a part of the format left out
PROGRAM_CONTROLS = {"w8a8_bf16_kv": (True, False), "bf16_int4_kv": (False, True), "bf16": (False, False)}
# name -> the reference's bits: the format computed in a lower precision
LOWER_CONTROLS = {"w4a8kv4": {"weight_bits": 4}, "w8a8kv2": {"kv_bits": 2}, "w8a8kv4_stream4": {"stream_kv_bits": 4}}
CONTROLS = (*PROGRAM_CONTROLS, *LOWER_CONTROLS)


def forced_tokens(ctx, served, w8a8: bool, kv4: bool):
    """The program's first choice at each served position, fed the served
    tokens (greedy, teacher-forced)."""
    import torch

    from duo_attention_tpu_torch.engine import DuoEngine
    from duo_attention_tpu_torch.models import llama
    from port_bench.core.serve import build_program
    from port_bench.drivers.closed_loop_formatted import formatted_params

    params, cfg, duo = build_program(ctx, formatted_params(ctx, w8a8))
    eng = DuoEngine(params, cfg, duo, batch_size=1, device=ctx.device, kv_quant="int4" if kv4 else "none")
    out = []
    with torch.no_grad():
        for prompt, toks in served:
            cache, logits = eng.prefill(np.asarray(prompt)[None])
            picks = [int(logits[0].argmax())]
            length = len(prompt)
            for t in toks[:-1]:
                tok = torch.tensor([[t]], dtype=torch.long, device=ctx.device)
                hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tok, 1,
                                                    full_bucket=eng.bucket_for(length + 1))
                picks.append(int(llama.logits_at(params, hidden, 0)[0].argmax()))
                length += 1
            out.append(picks)
            del cache
    del eng, params
    return out


def readings(ctx) -> dict:
    import torch

    from port_bench.drivers.closed_loop_formatted import VARIANTS, compared, reference_logits, run_formatted
    from port_bench.reference.model import gaps

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    served = run_formatted(ctx, check=False).notes["served"]
    sides = {"program": [toks for _, toks in served]}
    for name, (w8a8, kv4) in PROGRAM_CONTROLS.items():
        free()
        sides[name] = forced_tokens(ctx, served, w8a8, kv4)
    for name, bits in LOWER_CONTROLS.items():
        free()
        sides[name] = [lg.argmax(dim=-1).tolist() for lg in reference_logits(ctx, served, **bits)]
    free()
    logits = {v: reference_logits(ctx, served, v) for v in VARIANTS}
    out = {"served_tokens": sum(len(t) for _, t in served)}
    for side, chosen in sides.items():
        g = np.concatenate([gaps(lg, c) for lg, c in zip(logits["format"], chosen)])
        out[side] = dict(compared(logits, chosen), served_widest_gap=float(g.max()),
                         share_off_best=float(np.mean(g > 0)))
    return out


def judge(ctx, read) -> dict:
    """Each side's numbers against the cell's limits, by ``run.py``'s rule."""
    out = {}
    for side in ("program", *CONTROLS):
        checks = [(k, v, ctx.limits[k]) for k, v in read[side].items() if k in ctx.limits]
        out[side] = bool(checks) and all(harness.check_ok(v, lim) for _, v, lim in checks)
        for name, value, limit in checks:
            log(f"seed {ctx.seed} {side} {name}: {value!r} (limit {limit!r}) "
                f"{'ok' if harness.check_ok(value, limit) else 'FAILED'}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the controls of a formatted cell's correctness check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context.build(ROOT, args.workload, seed, args.seconds, False, time.monotonic())
        ctx.device = torch.device("cuda", 0)
        t0 = time.monotonic()
        read = readings(ctx)
        read["correct"] = judge(ctx, read)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.monotonic() - t0, **read}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
