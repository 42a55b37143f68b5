"""Gate training: ``GateTrainer.train_step`` on one passkey sequence a step.

Set-up makes the weights from the seed, builds one ``GateTrainer`` (the
trainer's default optimizer settings; sink and recent from the
configuration), sets its gates to values drawn from the seed (a run resumed
mid-training: at the initial gates of 1 the distillation term and its
gradient are exactly 0), and drives it through its first ``check.steps``
steps, which the reference follows. The window goes on with the same
trainer and the same feed, a new sequence a step, every step run whole.

Compared with the plain reference (``reference/train.py``), by the worst
layer's row of gates (a "leaf"): each of the first steps' loss, the norm of
the first gradient as AdamW got it (its first moment after one step over
1 - beta1), and the norm of the gates' change over the first steps.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from port_bench.core import counts, trace
from port_bench.core.harness import Outcome, log
from port_bench.core.passkey import MultiPasskeyDataset, PasskeyDataConfig
from port_bench.core.timeline import train_metrics
from port_bench.core.weights import Shape, make_params


def dataset(ctx) -> MultiPasskeyDataset:
    d = ctx.mix["data"]
    return MultiPasskeyDataset(PasskeyDataConfig(
        context_length_min=d["context_length_min"], context_length_max=d["context_length_max"],
        context_lengths_num_intervals=d["intervals"], num_passkeys=d["num_passkeys"],
        pad_to_multiple=d["pad_to_multiple"], seed=ctx.seed % (1 << 32)))


def initial_gates(ctx, shape: Shape) -> np.ndarray:
    lo, hi = ctx.mix["initial_gates"]
    rng = np.random.default_rng([ctx.seed & ((1 << 64) - 1), 3])
    return rng.uniform(lo, hi, (shape.layers, shape.kv_heads)).astype(np.float32)


def optimizer_settings(ctx, tcfg) -> dict:
    from duo_attention_tpu_torch.train import trainer as tr

    return {"lr": tcfg.lr, "warmup_steps": tcfg.warmup_steps, "num_steps": tcfg.num_steps,
            "reg_weight": tcfg.reg_weight, "b1": tr.ADAM_B1, "b2": tr.ADAM_B2, "eps": tr.ADAM_EPS,
            "weight_decay": tr.WEIGHT_DECAY, "sink": tcfg.sink_size, "recent": tcfg.recent_size}


def leaf_gap(prog: np.ndarray, ref: np.ndarray, drop: np.ndarray) -> float:
    """The worst layer's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median layer's; layers in ``drop`` left out."""
    pn, rn = np.linalg.norm(prog, axis=1), np.linalg.norm(ref, axis=1)
    keep = ~drop
    floor = np.median(rn[keep])
    return float(np.max(np.abs(pn - rn)[keep] / np.maximum(rn[keep], floor)))


def run(ctx) -> Outcome:
    import torch

    from duo_attention_tpu_torch.config import config_from_hf_dict
    from duo_attention_tpu_torch.train.trainer import GateTrainConfig, GateTrainer

    dev, conf, mix = ctx.device, ctx.conf, ctx.mix
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)  # the allocator exists before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    shape = Shape.of(conf)
    cfg = config_from_hf_dict(conf)
    tcfg = GateTrainConfig(sink_size=conf["duo"]["sink_size"], recent_size=conf["duo"]["recent_size"],
                           output_dir=str(ctx.out_dir / "gate_train"))
    trainer = GateTrainer(make_params(shape, ctx.seed, dev), cfg, tcfg, device=dev)
    gates0 = initial_gates(ctx, shape)
    with torch.no_grad():
        trainer.gates.copy_(torch.from_numpy(gates0))
    data = dataset(ctx)
    n_check = mix["check"]["steps"]
    batches, losses = [], []
    for i in range(n_check):
        b = data[i]
        batches.append((b["input_ids"], b["labels"]))
        losses.append(trainer.train_step(b["input_ids"][None], b["labels"][None])[0])
        if i == 0:
            mu = trainer.optimizer.state[trainer.gates]["exp_avg"]
            grad1 = (mu / (1.0 - optimizer_settings(ctx, tcfg)["b1"])).detach().cpu().numpy()
    gates_n = trainer.gates_numpy()
    if cuda:
        torch.cuda.synchronize(dev)
    w0 = time.monotonic()
    setup_s = w0 - ctx.t_start
    log(f"set-up {setup_s:.3f} s, of it {n_check} checked steps; losses {losses}")

    steps, idx, nonfinite = [], n_check, 0
    record = traced = None
    if ctx.trace:
        from torch.profiler import record_function

        from port_bench.core.profile import device_breakdown

        def span():
            nonlocal idx, nonfinite
            for _ in range(mix["trace_steps"]):
                b = data[idx]
                idx += 1
                with record_function(trace.STEP):
                    t = time.monotonic()
                    loss = trainer.train_step(b["input_ids"][None], b["labels"][None])[0]
                    record_steps.append((time.monotonic() - t, b["input_ids"].shape[0]))
                steps.append((t, time.monotonic(), int(b["input_ids"].shape[0])))  # a step of the window too
                nonfinite += not np.isfinite(loss)

        record_steps = []
        frozen = device_breakdown(span)
        traced = trace.reduce(frozen.pop("events"), frozen["wall_ms"])
        log(trace.summary(traced))
        record = {"trace": traced, "train_steps": record_steps, "model": counts.Model.of(conf), "conf": conf}
    while time.monotonic() < w0 + ctx.seconds:
        b = data[idx]
        idx += 1
        t = time.monotonic()
        loss = trainer.train_step(b["input_ids"][None], b["labels"][None])[0]
        steps.append((t, time.monotonic(), int(b["input_ids"].shape[0])))
        nonfinite += not np.isfinite(loss)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    e2e = train_metrics(steps, w0)
    e2e["setup_s"] = setup_s
    log(f"window: {len(steps)} steps, lengths {[s[2] for s in steps]}")
    opt = optimizer_settings(ctx, tcfg)
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from port_bench.reference.train import reference_steps

    t0 = time.monotonic()
    ref = reference_steps(conf, ctx.seed, dev, gates0, batches, opt)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, ref["loss"]))
    # a layer whose reference gradient is below a thousandth of the median layer's moves by round-off alone
    rn = np.linalg.norm(ref["grad1"], axis=1)
    drop = rn < 1e-3 * np.median(rn)
    grad_gap = leaf_gap(grad1, ref["grad1"], drop)
    change_gap = leaf_gap(gates_n - gates0, ref["gates"][-1] - gates0, drop)
    log(f"reference: {n_check} steps, {time.monotonic() - t0:.3f} s; losses {ref['loss']}; "
        f"layers left out {int(drop.sum())}")
    lim = ctx.limits
    out = Outcome(e2e=e2e, checks=[("train_loss_gap", loss_gap, lim["train_loss_gap"]),
                                   ("train_grad_gap", grad_gap, lim["train_grad_gap"]),
                                   ("train_change_gap", change_gap, lim["train_change_gap"])],
                  attempted=len(steps), failed=nonfinite, memory_peak_bytes=peak, record=record)
    if traced is not None:
        out.busy_s, out.window_s, out.breakdown = traced["busy_s"], traced["window_s"], trace.breakdown(traced)
    return out
