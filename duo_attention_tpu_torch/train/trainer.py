"""Gate-identification trainer, on one device or on a (data, seq) mesh.

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

Parallelism (``dp * sp > 1``): every rank of a (data, seq) mesh
(``build_mesh_for``; ``parallel.mesh.run_ranks(..., inner="seq")`` spawns
them) holds the gates and the optimizer whole and takes the step with the
same global batch: it keeps its rows (data) and its sequence shard (seq),
runs the two-way forward with Ulysses all_to_all over seq
(``parallel/ulysses.py``) and takes the distillation term's gradient of its
local sum over the global count; the ranks' gradients are summed. With
``fsdp`` the frozen params are split over every rank (``parallel/fsdp.py``)
and each layer is all-gathered where it is used. The L1 term is taken on the
replicated gates; AdamW and the clamp then run alike on every rank, and only
global rank 0 writes files. The JAX sharded step's gradient is N = dp x sp
times its one-device gradient (see ``_sharded_grads``); the port reproduces
that factor.

Run on the card, e.g.:

    python -m duo_attention_tpu_torch.train.trainer --model constructed-8b \\
        --sink 64 --recent 256 --lr 0.05 --num-steps 40 --context-min 1024 \\
        --context-max 2048 --num-passkeys 4 --pad-to 2048 --block-k 1024 \\
        --output-dir attn_patterns/constructed-8b

``--dp N --sp M [--fsdp]`` spawns N x M ranks (``parallel.mesh.run_ranks``;
gloo when they share a card or with ``--device cpu``, NCCL when each has a
card); the data's lengths are padded to a multiple of max(64, 128 x sp).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import ModelConfig
from ..models import llama
from ..parallel import mesh as pmesh
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
    # mesh (data, seq); (1, 1) = one device
    dp: int = 1
    sp: int = 1
    # shard the frozen params over the flattened mesh (parallel/fsdp.py)
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


def params_device(params) -> torch.device:
    return params["final_norm"].device


def build_mesh_for(tcfg: GateTrainConfig, device="cuda"):
    """The (data, seq) mesh of ``tcfg`` over the default process group (which
    must hold dp x sp ranks: ``parallel.mesh.init_distributed``), or None at
    dp x sp = 1. Rank r has data rank r // sp and seq rank r % sp, the way
    JAX reshapes its devices."""
    if tcfg.dp * tcfg.sp <= 1:
        return None
    from ..parallel.mesh import build_mesh

    return build_mesh(tcfg.sp, tcfg.dp, device=device, inner="seq")


class GateTrainer:
    """Trains the gates of a frozen model on ``device`` (the card unless the
    caller asks for the CPU; the params must already be there), or, with
    ``dp * sp > 1``, on this rank of ``mesh`` (``build_mesh_for``; every rank
    builds its trainer from the same whole params, and ``fsdp`` keeps its
    slices of them)."""

    def __init__(self, params, mcfg: ModelConfig, tcfg: GateTrainConfig, device="cuda", mesh=None):
        self.device = resolve_device(device if mesh is None else mesh.device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params are on {params_device(params)}, the trainer on {self.device}")
        if tcfg.dp < 1 or tcfg.sp < 1:
            raise ValueError(f"dp={tcfg.dp}, sp={tcfg.sp}: both must be at least 1")
        self.sharded = tcfg.dp * tcfg.sp > 1
        if self.sharded and (mesh is None or (mesh.data, mesh.tensor, mesh.inner) != (tcfg.dp, tcfg.sp, "seq")):
            raise ValueError(f"dp={tcfg.dp} x sp={tcfg.sp} needs this rank's (data, seq) mesh of that shape "
                             "(build_mesh_for, on ranks spawned by parallel.mesh.run_ranks(..., inner='seq'))")
        self.mesh = mesh if self.sharded else None
        self.layer_hook = None
        if self.sharded and tcfg.fsdp:
            from ..parallel import fsdp

            self.layer_specs = fsdp.param_specs(params, mesh.axis("world").size)["layers"][0]
            params = fsdp.shard_params(params, mesh)
            self.layer_hook = fsdp.make_gather_hook(self.layer_specs, mesh)
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

    @property
    def writes(self) -> bool:
        """Whether this trainer writes files: on one device, or on global rank 0."""
        return self.mesh is None or self.mesh.rank == 0

    # -- optimizer state: (count, mu, nu) and the schedule's count -----------

    def _set_opt_state(self, count: int, mu: torch.Tensor, nu: torch.Tensor) -> None:
        self.optimizer.state[self.gates] = {"step": torch.tensor(float(count)), "exp_avg": mu, "exp_avg_sq": nu}

    def _opt_state(self):
        st = self.optimizer.state[self.gates]
        return int(st["step"]), st["exp_avg"], st["exp_avg_sq"]

    def gates_numpy(self) -> np.ndarray:
        """A copy of the gates (on the CPU, ``numpy()`` alone would share the
        live tensor's memory)."""
        return self.gates.detach().cpu().numpy().copy()

    # -- checkpointing (reference train.py:202-236, 366-386) ----------------

    def save(self, tag: Optional[str] = None):
        if not self.writes:
            return
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
        if not self.writes:
            return
        save_attn_pattern(self.tcfg.output_dir, self.gates_numpy(), self.tcfg.sink_size, self.tcfg.recent_size,
                          extra_config={**dataclasses.asdict(self.tcfg), **(extra_config or {})})

    # -- training loop --------------------------------------------------------

    def compute_grads(self, ids: np.ndarray, labels: np.ndarray):
        """The step's loss terms (loss, distill, reg) as tensors, with the
        step's gradient left in ``gates.grad``. ids and labels [B, S] are the
        global batch (every rank of a mesh passes the same)."""
        # Supervise the PREDICTION positions: hidden state t predicts token
        # t+1, so the position feeding the first answer token enters the
        # distill mask (the JAX trainer's shift, trainer.py:265-281), shifted
        # over the whole sequence before it is sharded.
        labels = np.asarray(labels)
        labels = np.concatenate([labels[:, 1:], np.full((labels.shape[0], 1), IGNORE_INDEX, labels.dtype)], axis=1)
        ids = np.asarray(ids)
        self.optimizer.zero_grad(set_to_none=True)
        if self.sharded:
            return self._sharded_grads(ids, labels)
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        labels_t = torch.as_tensor(labels, device=self.device)
        with tracing.span("train.forward", device=self.device):
            loss, (d, reg) = self.loss_fn(self.gates, self.params, ids_t, labels_t)
        with tracing.span("train.backward", device=self.device):
            loss.backward()
        return loss.detach(), d.detach(), reg.detach()

    def _sharded_grads(self, ids: np.ndarray, labels: np.ndarray):
        """The rank's part of a dp x sp step: its rows and sequence shard
        through the Ulysses two-way forward; the distillation gradient of its
        local sum over the global count, summed over every rank."""
        data, seq, world = (self.mesh.axis(n) for n in ("data", "seq", "world"))
        B, S = ids.shape
        if B % data.size or S % seq.size:
            raise ValueError(f"a batch of {B} x {S} does not split over data {data.size} x seq {seq.size}")
        tcfg = self.tcfg
        ids_t = torch.as_tensor(_local(self.mesh, ids), dtype=torch.long, device=self.device)
        with tracing.span("train.forward", device=self.device):
            teacher, student = llama.forward_two_way(self.params, self.gates, self.mcfg, tcfg.sink_size,
                                                     tcfg.recent_size, ids_t, seq_axis=seq, block_k=tcfg.block_k,
                                                     layer_hook=self.layer_hook, remat=tcfg.remat)
            mask = torch.as_tensor(_local(self.mesh, labels) != IGNORE_INDEX, device=self.device)
            d = distill_loss(teacher, student, mask, axis_names=(data, seq))
        with tracing.span("train.backward", device=self.device):
            d.backward()
            if self.gates.grad is None:
                self.gates.grad = torch.zeros_like(self.gates)
            # JAX's sharded step differentiates its psum'd loss (duo_attention_tpu/train/loss.py:41-42)
            # inside shard_map: the transpose of a psum is a psum, so each device's gradient is already
            # N times its share, and the psum at duo_attention_tpu/train/trainer.py:140 makes the total
            # N = dp x sp times the one-device gradient. The sum over ranks of the local gradients is the
            # one-device gradient; the port multiplies it by N to take JAX's step.
            pmesh.axis_sum(world, self.gates.grad).mul_(world.size)
            # the L1 term on the replicated gates, outside (its gradient adds to gates.grad)
            reg = l1_loss(self.gates)
            (tcfg.reg_weight * reg).backward()
        d, reg = d.detach(), reg.detach()
        return d + tcfg.reg_weight * reg, d, reg

    def train_step(self, ids: np.ndarray, labels: np.ndarray):
        """One update from a batch of ids [B, S] and labels [B, S]; returns
        (loss, distill, reg) as floats. The step is a ``train.step`` span
        (``tracing``) around ``train.forward``, ``train.backward`` and
        ``train.update``; their device times are read once the loss has
        reached the host."""
        with tracing.span("train.step"):
            loss, d, reg = self.compute_grads(ids, labels)
            self.apply_grads()
            out = float(loss), float(d), float(reg)
        tracing.resolve()
        return out

    def apply_grads(self) -> None:
        """The update from ``gates.grad`` (kept as ``last_grad``): AdamW at
        the schedule's rate, then the clamp to [0, 1]."""
        with tracing.span("train.update", device=self.device):
            self.last_grad = self.gates.grad.detach().clone()
            self.optimizer.param_groups[0]["lr"] = self.schedule(self.sched_count)
            self.optimizer.step()
            with torch.no_grad():
                self.gates.clamp_(0.0, 1.0)  # reference train.py:98-102
        self.sched_count += 1
        self.step_idx += 1

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
    if args.dp < 1 or args.sp < 1:
        raise SystemExit(f"--dp {args.dp} --sp {args.sp}: both must be at least 1")
    if args.wandb:
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise RuntimeError("--wandb needs the wandb package, which is not installed") from e
    if args.dp * args.sp > 1:
        from ..parallel.mesh import run_ranks

        # dp x sp ranks, one process each (NCCL when each has a card, else gloo); rank 0 writes
        return run_ranks(_main_rank, args.sp, args.dp, args=(args,), device=args.device, inner="seq",
                         timeout_s=24 * 3600)[0]
    return _train(args)


def _main_rank(mesh, args):
    return _train(args, mesh)


def _train(args, mesh=None):
    """The CLI's run on one device or on this rank of the (data, seq) mesh;
    returns the final gates."""
    from ..evals.niah import build_model
    from ..models.constructed import SPECS
    from ..tokenizer import get_tokenizer
    from .data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator

    tcfg = GateTrainConfig(
        lr=args.lr, num_steps=args.num_steps, reg_weight=args.reg_weight, sink_size=args.sink,
        recent_size=args.recent, batch_size=args.batch_size, save_steps=args.save_steps,
        output_dir=args.output_dir, dp=args.dp, sp=args.sp, fsdp=args.fsdp, remat=not args.no_remat,
        block_k=args.block_k,
    )
    device = resolve_device(args.device) if mesh is None else mesh.device
    # constructed-8b is built in W8A8 on the device: its gate gradients flow through the STE
    params, mcfg, _ = build_model(args.model, args.model == "constructed-8b", device)
    trainer = GateTrainer(params, mcfg, tcfg, device=device, mesh=mesh)
    del params  # under FSDP the trainer keeps only its slices
    if args.resume:
        trainer.resume()
    tokenizer = get_tokenizer("word" if args.model in SPECS else args.tokenizer)
    dcfg = PasskeyDataConfig(context_length_min=args.context_min, context_length_max=args.context_max,
                             num_passkeys=args.num_passkeys, pad_to_multiple=max(64, 128 * tcfg.sp),
                             haystack_path=args.haystack)
    it = data_iterator(MultiPasskeyDataset(tokenizer, dcfg), tcfg.batch_size * max(tcfg.dp, 1), pad_to=args.pad_to)
    wandb_run = None
    if args.wandb and trainer.writes:
        import wandb

        wandb_run = wandb.init(project=args.wandb_project, name=os.path.basename(args.output_dir.rstrip("/")),
                               config=vars(args))
    try:
        trainer.train(it, log_every=args.log_every if trainer.writes else 1 << 62, wandb_run=wandb_run)
    finally:
        if wandb_run is not None:
            wandb_run.finish()
    return trainer.gates_numpy()


# ---------------------------------------------------------------------------
# Rank jobs (parallel.mesh.run_jobs on a (data, seq) mesh) and the dry run
# ---------------------------------------------------------------------------


def collectives_per_step(mcfg: ModelConfig, tcfg: GateTrainConfig) -> dict:
    """The training collectives of one dp x sp step on a rank
    (``parallel.mesh.train_collectives``): per layer 4 all_to_alls (q, k, v
    and the output) in the teacher, in the student's forward, in its
    recompute (remat) and in its backward, but the first layer's backward,
    whose attention inputs do not depend on the gates (none at sp = 1); with
    FSDP one all_gather of a layer's slices for the teacher, the student's
    block and its recompute (remat), or one shared by both streams (no
    remat); an all_reduce SUM for the loss on each axis of more than one rank
    and one for the gradient."""
    L = mcfg.num_layers
    a2a = ((16 if tcfg.remat else 12) * L - 4) if tcfg.sp > 1 else 0
    gathers = (3 if tcfg.remat else 1) * L if tcfg.fsdp else 0
    return {"all_to_all": a2a, "all_gather": gathers, "all_reduce.sum": (tcfg.dp > 1) + (tcfg.sp > 1) + 1}


def _local(mesh, a: np.ndarray) -> np.ndarray:
    """The rank's rows (data) and sequence shard (seq) of a global [B, S] array."""
    data, seq = mesh.axis("data"), mesh.axis("seq")
    rows, cols = a.shape[0] // data.size, a.shape[1] // seq.size
    return np.ascontiguousarray(a[data.rank * rows : (data.rank + 1) * rows, seq.rank * cols : (seq.rank + 1) * cols])


def two_way_job(mesh, params, mcfg: ModelConfig, gates: np.ndarray, ids: np.ndarray, labels: np.ndarray,
                sink_size: int, recent_size: int, block_k: int, fsdp: bool = False, remat: bool = False) -> dict:
    """``forward_two_way`` of the rank's shard of the global batch ``ids``
    (Ulysses over seq; with ``fsdp`` the params split and gathered a layer
    at a time) and ``distill_loss`` over both axes on the rank's ``labels``
    mask: the rank's teacher and student [B/dp, S/sp, E], the global loss,
    and the gradient of the local sum over the global count."""
    from ..parallel import fsdp as pfsdp

    hook = None
    if fsdp:
        specs = pfsdp.param_specs(params, mesh.axis("world").size)["layers"][0]
        params, hook = pfsdp.shard_params(params, mesh), pfsdp.make_gather_hook(specs, mesh)
    g = torch.as_tensor(gates, device=mesh.device).requires_grad_(True)
    teacher, student = llama.forward_two_way(params, g, mcfg, sink_size, recent_size,
                                             torch.as_tensor(_local(mesh, ids), device=mesh.device).long(),
                                             seq_axis=mesh.axis("seq"), block_k=block_k, layer_hook=hook, remat=remat)
    mask = torch.as_tensor(_local(mesh, labels) != IGNORE_INDEX, device=mesh.device)
    d = distill_loss(teacher, student, mask, axis_names=(mesh.axis("data"), mesh.axis("seq")))
    d.backward()
    return {"teacher": teacher.cpu().numpy(), "student": student.detach().cpu().numpy(), "distill": float(d),
            "local_grad": g.grad.cpu().numpy()}


def steps_job(mesh, params, mcfg: ModelConfig, tcfg: GateTrainConfig, batches, gates: Optional[np.ndarray] = None,
              resume: bool = False) -> dict:
    """``GateTrainer`` on this rank, built from the whole ``params``
    (``gates`` set first when given), one step a global (ids, labels) of
    ``batches``: each step's (loss, distill, reg), gradient, gates after it
    and training collectives (``parallel.mesh.train_collectives``), and the
    shapes of the rank's first layer. With ``resume``, rank 0 saves after the
    steps and a new trainer on every rank resumes it: (resumed, step, gates,
    Adam's mu)."""
    trainer = GateTrainer(params, mcfg, tcfg, mesh=mesh)
    if gates is not None:
        with torch.no_grad():
            trainer.gates.copy_(torch.as_tensor(gates))
    out = {"losses": [], "grads": [], "gates": [], "collectives": []}
    for ids, labels in batches:
        before = pmesh.train_collectives()
        out["losses"].append(trainer.train_step(ids, labels))
        out["collectives"].append({k: v - before[k] for k, v in pmesh.train_collectives().items()})
        out["grads"].append(trainer.last_grad.cpu().numpy())
        out["gates"].append(trainer.gates_numpy())
    out["layer0_shapes"] = {k: tuple(v.shape) for k, v in trainer.params["layers"][0].items()}
    if resume:
        trainer.save()
        pmesh.axis_sum(mesh.axis("world"), torch.zeros(1, device=mesh.device))  # rank 0 has written
        back = GateTrainer(params, mcfg, tcfg, mesh=mesh)
        ok = back.resume()
        out["resumed"] = (ok, back.step_idx, back.gates_numpy(), back._opt_state()[1].cpu().numpy())
    return out


def _dryrun_train_rank(mesh, device, output_dir: str) -> dict:
    """JAX ``dryrun_train_step``'s model and step on this rank of the (data,
    seq) mesh: a finite loss, equal on every rank."""
    mcfg = ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=8,
                       num_kv_heads=4, head_dim=8)
    dp, sp = mesh.data, mesh.tensor
    tcfg = GateTrainConfig(num_steps=2, sink_size=8, recent_size=16, dp=dp, sp=sp, block_k=64,
                           output_dir=output_dir)
    params = llama.init_params(mcfg, seed=0, dtype=torch.float32, device=device)
    trainer = GateTrainer(params, mcfg, tcfg, device=device, mesh=mesh if dp * sp > 1 else None)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (max(dp, 1), 128 * sp)).astype(np.int32)
    labels = np.where(rng.uniform(size=ids.shape) < 0.1, ids, IGNORE_INDEX)
    loss, d, reg = trainer.train_step(ids, labels)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_train_step: loss {loss}")
    return {"loss": loss, "distill": d, "reg": reg, "gates": trainer.gates_numpy()}


def dryrun_train_step(n_devices: int, device="cuda", **kw) -> dict:
    """One dp x sp sharded gate-training step on tiny shapes (JAX
    ``dryrun_train_step``: dp 2 when ``n_devices`` is even, sp the rest) on
    ``n_devices`` new ranks; rank 0's loss, distill, reg and gates. ``kw``
    goes to ``run_ranks``."""
    import tempfile

    from ..parallel.mesh import run_ranks

    dp = 2 if n_devices % 2 == 0 else 1
    sp = n_devices // dp
    with tempfile.TemporaryDirectory() as out:
        results = run_ranks(_dryrun_train_rank, sp, dp, args=(str(device), out), device=device, inner="seq", **kw)
    if any(r["loss"] != results[0]["loss"] for r in results):
        raise AssertionError(f"dryrun_train_step: the ranks' losses differ: {[r['loss'] for r in results]}")
    print(f"[dryrun] gate-training step dp={dp} x sp={sp} on {device}: loss {results[0]['loss']:.6f}", flush=True)
    return results[0]


if __name__ == "__main__":
    main()
