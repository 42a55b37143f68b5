#!/usr/bin/env python3
"""Two forms of the blockwise attention's masked exp, timed in one run.

    python3 scripts/blockwise_mask_variants.py   # on one GPU, ~1 min

``ops/blockwise.py`` takes p = exp(where(mask, s - m, -inf)): one select
feeding the exp. The other form selects twice, p = where(mask, exp(where(mask,
s - m, 0)), 0), which keeps the exp's arguments finite (the CPU's exp is
slower for arguments whose result is not a normal float32) at the cost of a
second pass over the float32 scores. Both give the same p and gradients;
the script checks that bitwise first.

Two measurements, each in the order one, two, two, one (so a drift of the
card's clock shows as a difference between the two runs of a form):
- one layer's attention as a gate-training step runs it, at 2,048 and 4,096
  tokens (the 8B model's 32 q and 8 KV heads of 128, sink 64, recent 256,
  block 1024): the teacher's causal pass without a gradient, then the
  student's Lambda pass under a checkpoint and its backward; device ms of
  one layer between CUDA events;
- whole ``GateTrainer`` steps on constructed-8b in W8A8 (built on the card)
  at 2,048 tokens, B = 1: wall seconds a step through a synchronize.

Prints the card's name and power limit and one line a measurement; writes
chiprun_out/blockwise_mask_variants.json. Needs a card; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SINK, RECENT, BLOCK, LAYER_LENS, STEP_LEN, STEPS = 64, 256, 1024, (2048, 4096), 2048, 3
ORDER = ("one", "two", "two", "one")


def main():
    import numpy as np
    import torch
    from torch.utils.checkpoint import checkpoint

    from duo_attention_tpu_torch.evals.niah import build_model
    from duo_attention_tpu_torch.ops import blockwise
    from duo_attention_tpu_torch.tokenizer import get_tokenizer
    from duo_attention_tpu_torch.train.data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator
    from duo_attention_tpu_torch.train.trainer import GateTrainConfig, GateTrainer
    from duo_attention_tpu_torch.utils import cuda_time_ms

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)

    one = blockwise._block

    def two(qf, k_blk, v_blk, m_prev, l_prev, acc, mask, scale):
        s = torch.einsum("bhgsd,bhtd->bhgst", qf, k_blk.float()) * scale
        s = torch.where(mask, s, blockwise.NEG_INF)
        m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(torch.where(mask, s - m_next, 0.0)), 0.0)
        alpha = torch.exp(m_prev - m_next)
        l_next = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", p, v_blk.float())
        return m_next, l_next, acc

    forms = {"one": one, "two": two}
    out = {"nvidia_smi": smi, "layer_ms": {}, "step_s": {}}
    lam = blockwise.lambda_mask_fn(SINK, RECENT)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for S in LAYER_LENS:
        q, k, v = (torch.randn((1, S, h, 128), generator=gen, device="cuda").to(torch.bfloat16) for h in (32, 8, 8))
        ct = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)

        def layer():
            with torch.no_grad():
                teacher = blockwise.blockwise_attention(q, k, v, blockwise.causal_mask_fn, block_k=BLOCK)
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
            student = checkpoint(lambda a, b, c: blockwise.blockwise_attention(a, b, c, lam, block_k=BLOCK),
                                 qs, ks, vs, use_reentrant=False)
            student.backward(ct)
            return teacher, student.detach(), qs.grad, ks.grad, vs.grad

        results = {}
        for name, form in forms.items():
            blockwise._block = form
            results[name] = layer()
        same = all(torch.equal(a, b) for a, b in zip(results["one"], results["two"]))
        if not same:
            print(f"FAIL: the two forms differ at {S} tokens", file=sys.stderr)
            return 1
        del results
        runs = []
        for name in ORDER:
            blockwise._block = forms[name]
            runs.append((name, cuda_time_ms(layer, iters=3, warmup=1)))
        out["layer_ms"][S] = runs
        print(f"one layer at {S} tokens, device ms (bitwise equal: {same}): "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in runs))
        del q, k, v, ct
    blockwise._block = one
    torch.cuda.empty_cache()

    params, cfg, _ = build_model("constructed-8b", True, "cuda")
    tcfg = GateTrainConfig(lr=0.05, reg_weight=0.05, num_steps=100, warmup_steps=4, sink_size=SINK,
                           recent_size=RECENT, batch_size=1, save_steps=1000, block_k=BLOCK,
                           output_dir=str(REPO / "chiprun_out" / "blockwise_mask_variants"))
    trainer = GateTrainer(params, cfg, tcfg, device="cuda")
    dcfg = PasskeyDataConfig(context_length_min=1024, context_length_max=STEP_LEN, num_passkeys=4,
                             pad_to_multiple=128)
    it = data_iterator(MultiPasskeyDataset(get_tokenizer("word"), dcfg), 1, pad_to=STEP_LEN)
    batch = next(it)
    trainer.train_step(batch["input_ids"], batch["labels"])  # warm-up
    runs = []
    for name in ORDER:
        blockwise._block = forms[name]
        walls = []
        for _ in range(STEPS):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch["input_ids"], batch["labels"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        runs.append((name, float(np.median(walls)), walls))
        print(f"GateTrainer step at {STEP_LEN} tokens, {name} select(s): {walls} s (median {runs[-1][1]:.4f})")
    blockwise._block = one
    out["step_s"][STEP_LEN] = runs
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    with open(REPO / "chiprun_out" / "blockwise_mask_variants.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
