"""The control of a cell's correctness check: readings of the program and of
the program in the next precision below the configuration's.

The configurations are bf16; the program's own step below is its W8A8 path
(``ops/quant.py``: int8 weights and per-token int8 activations in every
decoder projection, with ``quantize_embeddings_int8`` the embedding and the
head too), over the same bf16 KV cache. For each seed:

- serving: the cell runs for ``--seconds`` at its own load and keeps its
  sample (``core/serve.py``); the program's reading is the widest gap of its
  served tokens. The control is the W8A8 program fed the same prompts and
  served tokens (prefill, then one eager decode step a token, as the pool
  decodes): at each position the token it puts first, read in the float32
  reference's logits. Beside it, ``reference_int8``: the reference itself
  with every product in W8A8, the experts too (the program's W8A8 path
  keeps a MoE layer's experts in bf16).
- gate training: the cell's checked steps, by the bf16 trainer (the
  program's reading) and by a trainer over the W8A8 weights (the control),
  against one run of the reference.

    python3 port_bench/control.py --workload <name> --seeds 11,12,13 [--seconds 20]

on the card (it refuses the CPU, as ``run.py`` does). Prints one JSON line
a seed: each side's numbers, and the ``correct`` that ``harness.check_ok``
gives each side against the cell's limits, as ``run.py`` decides it.
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


def w8a8(params):
    from duo_attention_tpu_torch.ops.quant import quantize_embeddings_int8, quantize_params_w8a8

    return quantize_embeddings_int8(quantize_params_w8a8(params))


def control_tokens(ctx, served):
    """The W8A8 program's first choice at each served position, fed the
    served tokens (greedy, teacher-forced)."""
    import torch

    from duo_attention_tpu_torch.engine import DuoEngine
    from duo_attention_tpu_torch.models import llama
    from port_bench.core.serve import build_program

    params, cfg, duo = build_program(ctx)
    params = w8a8(params)
    eng = DuoEngine(params, cfg, duo, batch_size=1, device=ctx.device)
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


def serving_readings(ctx):
    """The program's and the control's served-token numbers on one seed."""
    import torch

    from port_bench.core import serve
    from port_bench.reference.model import gaps, logits_at

    served = serve.run_serving(ctx, closed=ctx.mix["driver"] == "closed_loop", check=False).notes["served"]
    gc.collect()
    torch.cuda.empty_cache()
    ctrl = control_tokens(ctx, served)
    gc.collect()
    torch.cuda.empty_cache()
    ref_int8 = [lg.argmax(dim=-1).cpu().numpy() for lg in logits_at(ctx.conf, ctx.seed, served, ctx.device, int8=True)]
    margins = []
    logits = logits_at(ctx.conf, ctx.seed, served, ctx.device, margins=margins)
    prog = np.concatenate([gaps(lg, toks) for lg, (_, toks) in zip(logits, served)])
    ctl = np.concatenate([gaps(lg, c) for lg, c in zip(logits, ctrl)])
    ctl_ref = np.concatenate([gaps(lg, c) for lg, c in zip(logits, ref_int8)])
    jp, jc = serve.judged(ctx, prog, margins), serve.judged(ctx, ctl, margins)
    out = {"program": {"served_widest_gap": float(jp.max()), "served_mean_gap": float(jp.mean())},
           "control": {"served_widest_gap": float(jc.max()), "served_mean_gap": float(jc.mean())},
           "served_tokens": len(prog), "judged": len(jp), "stats": {}}
    floors = [None] + ([0.01, 0.02, 0.05, 0.1] if margins else [])
    low = np.concatenate(margins) if margins else None
    for floor in floors:
        keep = np.ones(len(prog), bool) if floor is None else low >= floor
        out["stats"][f"margin>={floor}" if floor else "all"] = {"kept": int(keep.sum()), **{
            name: {"widest": float(g[keep].max()), "p90": float(np.quantile(g[keep], 0.9)), "mean": float(g[keep].mean()),
                   "share_off_best": float(np.mean(g[keep] > 0))}
            for name, g in (("program", prog), ("control", ctl), ("reference_int8", ctl_ref)) if keep.any()}}
    return out


def training_readings(ctx):
    """Each number of the training check for the program and the control."""
    import torch

    from duo_attention_tpu_torch.config import config_from_hf_dict
    from duo_attention_tpu_torch.train.trainer import GateTrainConfig, GateTrainer
    from port_bench.drivers import gate_train as gt
    from port_bench.core.weights import Shape, make_params
    from port_bench.reference.train import reference_steps

    conf, dev = ctx.conf, ctx.device
    shape = Shape.of(conf)
    cfg = config_from_hf_dict(conf)
    tcfg = GateTrainConfig(sink_size=conf["duo"]["sink_size"], recent_size=conf["duo"]["recent_size"],
                           output_dir=str(ctx.out_dir / "gate_train"))
    gates0 = gt.initial_gates(ctx, shape)
    data = gt.dataset(ctx)
    batches = [(data[i]["input_ids"], data[i]["labels"]) for i in range(ctx.mix["check"]["steps"])]
    runs = {}
    for name, quant in (("program", False), ("control", True)):
        params = make_params(shape, ctx.seed, dev)
        trainer = GateTrainer(w8a8(params) if quant else params, cfg, tcfg, device=dev)
        del params
        with torch.no_grad():
            trainer.gates.copy_(torch.from_numpy(gates0))
        losses = []
        for i, (ids, labels) in enumerate(batches):
            losses.append(trainer.train_step(ids[None], labels[None])[0])
            if i == 0:
                grad1 = (trainer.optimizer.state[trainer.gates]["exp_avg"] / 0.1).cpu().numpy()
        runs[name] = (losses, grad1, trainer.gates_numpy())
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    ref = reference_steps(conf, ctx.seed, dev, gates0, batches, gt.optimizer_settings(ctx, tcfg))
    rn = np.linalg.norm(ref["grad1"], axis=1)
    drop = rn < 1e-3 * np.median(rn)
    out = {}
    for name, (losses, grad1, gates) in runs.items():
        out[name] = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses, ref["loss"])),
                     "grad_gap": gt.leaf_gap(grad1, ref["grad1"], drop),
                     "change_gap": gt.leaf_gap(gates - gates0, ref["gates"][-1] - gates0, drop)}
    return out


def judge(ctx, read) -> dict:
    """Each side's numbers against the cell's limits, by ``run.py``'s rule:
    correct where every number that has a limit is within it."""
    out = {}
    for side in ("program", "control"):
        prefix = "train_" if ctx.mix["driver"] == "gate_train" else ""
        checks = [(prefix + k, v, ctx.limits[prefix + k]) for k, v in read[side].items() if prefix + k in ctx.limits]
        out[side] = bool(checks) and all(harness.check_ok(v, lim) for _, v, lim in checks)
        for name, value, limit in checks:
            log(f"seed {ctx.seed} {side} {name}: {value!r} (limit {limit!r}) "
                f"{'ok' if harness.check_ok(value, limit) else 'FAILED'}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of a cell's correctness check")
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
        read = training_readings(ctx) if ctx.mix["driver"] == "gate_train" else serving_readings(ctx)
        read["correct"] = judge(ctx, read)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.monotonic() - t0, **read}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
