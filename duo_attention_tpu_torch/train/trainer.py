"""Gate-identification trainer on one device.

Counterpart of duo_attention_tpu/train/trainer.py: AdamW on the per-(layer,
KV-head) gates only, distillation MSE + L1 regularizer, the gates clamped to
[0, 1] after each step, linear warmup then linear decay, TSV and
optimizer-state checkpoints with resume, and the reference artifact layout
(full_attention_heads.tsv + config.json).

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` constants (b1
0.9, b2 0.999, eps 1e-8, weight decay 1e-4; PyTorch's own default decay is
0.01). Its learning rate is ``lr_schedule`` at the count of earlier updates,
as optax evaluates a schedule before it counts the update, so the first
update has lr 0. Checkpoints use the JAX package's file names and its
``opt_state_{tag}.npz`` layout (``step`` int64, ``gates`` [L, Hkv] float32,
``arr_0`` the Adam count int32, ``arr_1`` mu, ``arr_2`` nu, ``arr_3`` the
schedule count int32), so either package resumes the other's checkpoint.

The data- and sequence-parallel mesh, FSDP and ``dryrun_train_step`` come
with the parallel layouts (ROADMAP.md §1 item 8): a ``dp * sp > 1`` or
``fsdp`` config raises.

Run on the card, e.g.:

    python -m duo_attention_tpu_torch.train.trainer --model constructed-8b \\
        --sink 64 --recent 256 --lr 0.05 --num-steps 40 --context-min 1024 \\
        --context-max 2048 --num-passkeys 4 --pad-to 2048 --block-k 1024 \\
        --output-dir attn_patterns/constructed-8b
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import llama
from ..patterns import save_attn_pattern, save_full_attention_heads
from ..utils import resolve_device
from .data import IGNORE_INDEX
from .loss import distill_loss, l1_loss

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


@dataclass
class GateTrainConfig:
    lr: float = 0.02
    num_steps: int = 2000
    warmup_steps: int = 20
    reg_weight: float = 0.05
    sink_size: int = 128
    recent_size: int = 256
    batch_size: int = 1
    save_steps: int = 50
    output_dir: str = "attn_patterns/run"
    seed: int = 42
    block_k: int = 512
    # mesh (data, seq) and FSDP: kept for the artifact's config.json; only
    # (1, 1) without FSDP runs here
    dp: int = 1
    sp: int = 1
    fsdp: bool = False
    # per-layer activation checkpointing of the student stream
    remat: bool = True


def lr_schedule(cfg: GateTrainConfig):
    """Linear warmup then linear decay to zero, in float32 as the JAX
    schedule computes it: step -> lr."""
    f32 = np.float32

    def fn(step):
        step = f32(step)
        warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
        decay = np.maximum(f32(1.0) - (step - f32(cfg.warmup_steps))
                           / f32(max(cfg.num_steps - cfg.warmup_steps, 1)), f32(0.0))
        return float(f32(cfg.lr) * (warm if step < cfg.warmup_steps else decay))

    return fn


def make_loss_fn(mcfg: ModelConfig, tcfg: GateTrainConfig):
    """(gates, params, input_ids, labels) -> (loss, (distill, reg)), tensors."""

    def loss_fn(gates, params, input_ids, labels):
        teacher, student = llama.forward_two_way(params, gates, mcfg, tcfg.sink_size, tcfg.recent_size,
                                                 input_ids, block_k=tcfg.block_k, remat=tcfg.remat)
        d = distill_loss(teacher, student, labels != IGNORE_INDEX)
        reg = l1_loss(gates)
        return d + tcfg.reg_weight * reg, (d, reg)

    return loss_fn


def _check_single_device(tcfg: GateTrainConfig) -> None:
    if tcfg.dp * tcfg.sp > 1 or tcfg.fsdp:
        raise NotImplementedError(f"dp={tcfg.dp}, sp={tcfg.sp}, fsdp={tcfg.fsdp}: data and sequence parallel "
                                  "gate training and FSDP come with the parallel layouts (ROADMAP.md §1 item 8)")


def params_device(params) -> torch.device:
    return params["final_norm"].device


class GateTrainer:
    """Trains the gates of a frozen model on ``device`` (the card unless the
    caller asks for the CPU; the params must already be there)."""

    def __init__(self, params, mcfg: ModelConfig, tcfg: GateTrainConfig, device="cuda"):
        _check_single_device(tcfg)
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params are on {params_device(params)}, the trainer on {self.device}")
        self.params = params
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.loss_fn = make_loss_fn(mcfg, tcfg)
        self.schedule = lr_schedule(tcfg)
        # init 1.0 (reference patch/llama.py:471-476)
        self.gates = torch.ones((mcfg.num_layers, mcfg.num_kv_heads), dtype=torch.float32, device=self.device,
                                requires_grad=True)
        self.optimizer = torch.optim.AdamW([self.gates], lr=0.0, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                           weight_decay=WEIGHT_DECAY, foreach=False)
        self._set_opt_state(0, torch.zeros_like(self.gates), torch.zeros_like(self.gates))
        self.sched_count = 0
        self.step_idx = 0
        os.makedirs(tcfg.output_dir, exist_ok=True)

    # -- optimizer state: (count, mu, nu) and the schedule's count -----------

    def _set_opt_state(self, count: int, mu: torch.Tensor, nu: torch.Tensor) -> None:
        self.optimizer.state[self.gates] = {"step": torch.tensor(float(count)), "exp_avg": mu, "exp_avg_sq": nu}

    def _opt_state(self):
        st = self.optimizer.state[self.gates]
        return int(st["step"]), st["exp_avg"], st["exp_avg_sq"]

    def gates_numpy(self) -> np.ndarray:
        return self.gates.detach().cpu().numpy()

    # -- checkpointing (reference train.py:202-236, 366-386) ----------------

    def save(self, tag: Optional[str] = None):
        tag = tag if tag is not None else f"step={self.step_idx}"
        out = self.tcfg.output_dir
        gates = self.gates_numpy()
        save_full_attention_heads(gates, os.path.join(out, f"full_attention_heads_{tag}.tsv"))
        try:  # the gate heatmap beside the TSV, best effort as in JAX
            from ..patterns import visualize_head_map

            visualize_head_map(gates, os.path.join(out, "head_map_latest.png"), title=f"step {self.step_idx}")
        except Exception:
            pass
        count, mu, nu = self._opt_state()
        np.savez(os.path.join(out, f"opt_state_{tag}.npz"), np.asarray(count, np.int32),
                 mu.detach().cpu().numpy(), nu.detach().cpu().numpy(), np.asarray(self.sched_count, np.int32),
                 step=self.step_idx, gates=gates)
        for src, dst in ((f"full_attention_heads_{tag}.tsv", "full_attention_heads_latest.tsv"),
                         (f"opt_state_{tag}.npz", "opt_state_latest.npz")):
            shutil.copyfile(os.path.join(out, src), os.path.join(out, dst))

    def resume(self) -> bool:
        path = os.path.join(self.tcfg.output_dir, "opt_state_latest.npz")
        if not os.path.exists(path):
            return False
        data = np.load(path)
        self.step_idx = int(data["step"])
        with torch.no_grad():
            self.gates.copy_(torch.from_numpy(np.asarray(data["gates"], np.float32)))
        mu, nu = (torch.from_numpy(np.asarray(data[k], np.float32)).to(self.device) for k in ("arr_1", "arr_2"))
        self._set_opt_state(int(data["arr_0"]), mu, nu)
        self.sched_count = int(data["arr_3"])
        return True

    def finalize(self, extra_config: Optional[dict] = None):
        """Write the reference-compatible artifact: TSV + config.json."""
        save_attn_pattern(self.tcfg.output_dir, self.gates_numpy(), self.tcfg.sink_size, self.tcfg.recent_size,
                          extra_config={**dataclasses.asdict(self.tcfg), **(extra_config or {})})

    # -- training loop --------------------------------------------------------

    def train_step(self, ids: np.ndarray, labels: np.ndarray):
        """One update from a batch of ids [B, S] and labels [B, S]; returns
        (loss, distill, reg) as floats."""
        # Supervise the PREDICTION positions: hidden state t predicts token
        # t+1, so the position feeding the first answer token enters the
        # distill mask (the JAX trainer's shift, trainer.py:265-281).
        labels = np.asarray(labels)
        labels = np.concatenate([labels[:, 1:], np.full((labels.shape[0], 1), IGNORE_INDEX, labels.dtype)], axis=1)
        ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        labels_t = torch.as_tensor(labels, device=self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss, (d, reg) = self.loss_fn(self.gates, self.params, ids_t, labels_t)
        loss.backward()
        self.optimizer.param_groups[0]["lr"] = self.schedule(self.sched_count)
        self.optimizer.step()
        with torch.no_grad():
            self.gates.clamp_(0.0, 1.0)  # reference train.py:98-102
        self.sched_count += 1
        self.step_idx += 1
        return float(loss.detach()), float(d.detach()), float(reg.detach())

    def train(self, data_iter, log_every: int = 10, wandb_run=None):
        for _ in range(self.step_idx, self.tcfg.num_steps):
            batch = next(data_iter)
            loss, d, reg = self.train_step(batch["input_ids"], batch["labels"])
            lr = self.schedule(self.step_idx)
            if self.step_idx % log_every == 0:
                print(f"[train] step {self.step_idx} loss={loss:.5f} distill={d:.5f} reg={reg:.5f} "
                      f"lr={lr:.5f} len={batch['input_ids'].shape[1]}", flush=True)
            if wandb_run is not None:
                wandb_run.log({"loss": loss, "distill_loss": d, "reg_loss": reg, "lr": lr,
                               "sample_len": batch["input_ids"].shape[1], "step": self.step_idx})
            if self.step_idx % self.tcfg.save_steps == 0:
                self.save()
        self.finalize()


def main(argv=None):
    import argparse

    from ..evals.niah import build_model
    from ..models.constructed import SPECS
    from ..tokenizer import get_tokenizer
    from .data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator

    p = argparse.ArgumentParser(description="duo-attention gate training")
    p.add_argument("--model", default="tiny-gqa",
                   help="preset name, or a constructed circuit ('constructed', 'constructed-long', "
                   "'constructed-8b', 'constructed-d128'): the hand-built retrieval circuit with KNOWN "
                   "retrieval heads")
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--reg-weight", type=float, default=0.05)
    p.add_argument("--num-steps", type=int, default=2000)
    p.add_argument("--sink", type=int, default=128)
    p.add_argument("--recent", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--context-min", type=int, default=1000)
    p.add_argument("--context-max", type=int, default=32000)
    p.add_argument("--num-passkeys", type=int, default=10)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true", help="shard the frozen params over the dp x sp mesh")
    p.add_argument("--no-remat", action="store_true", help="disable per-layer activation checkpointing")
    p.add_argument("--save-steps", type=int, default=50)
    p.add_argument("--output-dir", default="attn_patterns/run")
    p.add_argument("--tokenizer", default="byte")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--haystack", default=None)
    p.add_argument("--pad-to", type=int, default=None, help="fixed batch length")
    p.add_argument("--block-k", type=int, default=512)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--wandb", action="store_true", help="log per-step metrics to wandb")
    p.add_argument("--wandb-project", default="duo-attention-tpu")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    tcfg = GateTrainConfig(
        lr=args.lr, num_steps=args.num_steps, reg_weight=args.reg_weight, sink_size=args.sink,
        recent_size=args.recent, batch_size=args.batch_size, save_steps=args.save_steps,
        output_dir=args.output_dir, dp=args.dp, sp=args.sp, fsdp=args.fsdp, remat=not args.no_remat,
        block_k=args.block_k,
    )
    _check_single_device(tcfg)
    wandb = None
    if args.wandb:
        try:
            import wandb
        except ImportError as e:
            raise RuntimeError("--wandb needs the wandb package, which is not installed") from e
    device = resolve_device(args.device)
    # constructed-8b is built in W8A8 on the device: its gate gradients flow through the STE
    params, mcfg, _ = build_model(args.model, args.model == "constructed-8b", device)
    trainer = GateTrainer(params, mcfg, tcfg, device=device)
    if args.resume:
        trainer.resume()
    tokenizer = get_tokenizer("word" if args.model in SPECS else args.tokenizer)
    dcfg = PasskeyDataConfig(context_length_min=args.context_min, context_length_max=args.context_max,
                             num_passkeys=args.num_passkeys, pad_to_multiple=max(64, 128 * tcfg.sp),
                             haystack_path=args.haystack)
    it = data_iterator(MultiPasskeyDataset(tokenizer, dcfg), tcfg.batch_size * max(tcfg.dp, 1), pad_to=args.pad_to)
    wandb_run = None
    if wandb is not None:
        wandb_run = wandb.init(project=args.wandb_project, name=os.path.basename(args.output_dir.rstrip("/")),
                               config=vars(args))
    try:
        trainer.train(it, log_every=args.log_every, wandb_run=wandb_run)
    finally:
        if wandb_run is not None:
            wandb_run.finish()


if __name__ == "__main__":
    main()
