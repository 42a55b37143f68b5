"""The (data, tensor) mesh on ``torch.distributed``, its collectives, the
tensor-parallel sharding rules and the TP dry runs.

Counterpart of duo_attention_tpu/parallel/mesh.py. JAX runs one controller
under GSPMD: ``shardings_like`` states a layout and XLA inserts the psums and
any resharding. Here every rank runs the host loop, holds only its own
slices and calls the collectives itself, so the layout is explicit:

* **One head assignment per layer** (``layer_shards``), shared by the
  projections and the cache. With hf full and hs streaming KV heads in layer
  l, when both divide ``tensor`` (a zero count divides) rank r owns full
  heads [r hf/tp, (r+1) hf/tp), streaming heads hf + [r hs/tp, (r+1) hs/tp)
  and the G query heads of each; its wq/wk/wv rows and wo columns are
  gathered by that index list (the port keeps HF's [out, in] layout and the
  weights were reordered to put the full heads first, so these are not
  contiguous slices). A layer whose counts do not divide is **replicated**:
  every rank computes all its heads and its wo output needs no all_reduce.
  JAX shards the two groups of such a layer independently (``spmd.py
  can_shard_heads`` per group); replicating the whole layer gives the same
  numbers with no collective inside attention, but on such layers the
  per-rank KV bytes differ from JAX's (all of the layer's heads, not a
  group's shard).
* **MLP, megatron style**: w_gate/w_up split by rows, w_down by columns, one
  all_reduce after w_down, when ``intermediate_size % tp == 0``. A MoE layer's
  stacked experts [X, out, in] split over the expert axis when X % tp == 0;
  each rank's dense-dispatch partial sum is all_reduced; the router stays
  replicated (expert parallelism).
* **Embed and head, vocab-parallel** when vocab % tp == 0 (the int8 tables
  and their per-row scales alike): the lookup zeroes the rows outside the
  rank's range, then all_reduce SUM (exact); the head computes its vocab
  slice, placed in a zero [B, V] float32 tensor and all_reduced (exact), so
  every rank holds the same logits and picks the same token; the engines
  broadcast it from tensor-rank 0 all the same.
* **W8A8**: column shards keep their per-channel scales (exact); a row shard
  (wo, w_down) quantizes x with the per-token absmax all_reduced (MAX) across
  ranks, as GSPMD's psum-max, and sums float32 partial products
  (``ops/quant.py::w8a8_linear_row_split``).
* **Only all_reduce (SUM, MAX) and broadcast** on the inference paths, the
  collectives gloo offers on CUDA tensors, so one code path runs under gloo
  (the CPU tests, two ranks sharing one card) and NCCL. Each call is counted
  (``ops/launches.py``). NCCL collectives can be captured in a CUDA graph;
  gloo's cannot, so ``Mesh.capturable`` tells the engines whether to capture
  their decode step.
* **Training's collectives**: gate training runs on a (data, seq) mesh, the
  same ranks and groups with the inner axis named ``seq`` (``build_mesh(...,
  inner="seq")``, ``run_ranks(..., inner="seq")``). Ulysses needs
  ``all_to_all`` over the seq group and FSDP ``all_gather`` over every rank
  (``Mesh.axis("world")``); gloo (torch 2.11, on the H100) and NCCL both take
  them on the card's tensors. They are counted apart from the inference
  collectives (``train_collectives``): no training step is captured.
* **The data axis**: a batch that divides ``data`` is split over the data
  groups, each of which runs its slice alone (as ``cache_shardings`` shards
  the batch only when it divides); results are gathered through a
  zero-padded all_reduce over the data group.

Ranks are laid out as JAX's mesh reshapes its devices: global rank r has
data rank r // tensor and tensor rank r % tensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import DuoConfig, ModelConfig
from ..utils import resolve_device

# A collective that waits longer than this raises (a rank that died or hung).
GROUP_TIMEOUT_S = 300.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the (data, tensor) mesh: the sizes, its ranks, the
    process groups of its tensor group (ranks with its data rank) and of its
    data group (ranks with its tensor rank), the backend and the rank's
    device."""

    tensor: int
    data: int
    rank: int
    tensor_rank: int
    data_rank: int
    tensor_group: Any
    data_group: Any
    tensor_src: int  # global rank of tensor-rank 0 in this rank's tensor group
    backend: str
    device: torch.device
    inner: str = "tensor"  # the inner axis's name: "tensor", or "seq" for gate training

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL's
        can (once the communicator is warm), gloo's cannot."""
        return self.backend == "nccl"

    def axis(self, name: str) -> "Axis":
        """The named axis as this rank sees it: "data", the inner axis
        (``inner``; "tensor" also names it) or "world" (every rank, in rank
        order: data major, as JAX flattens ("data", "seq"))."""
        if name == "data":
            return Axis(name, self.data, self.data_rank, self.data_group, self)
        if name in (self.inner, "tensor"):
            return Axis(name, self.tensor, self.tensor_rank, self.tensor_group, self)
        if name == "world":
            return Axis(name, self.data * self.tensor, self.rank, None, self)
        raise ValueError(f"mesh axes are data, {self.inner} and world, not {name!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One axis of a mesh as a rank sees it: its name, size, the rank's index
    on it, its process group (None: the default group, every rank) and the
    mesh."""

    name: str
    size: int
    rank: int
    group: Any
    mesh: Mesh


def default_backend(device, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card: NCCL refuses two ranks on one GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda") -> None:
    """Join the default process group (``default_backend`` for ``device``).
    With no ``init_method`` the environment gives it (torchrun: ``env://``
    with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT); else pass the method
    (``tcp://host:port``, or ``file://`` on a fresh path), the world size and
    the rank. On the card each rank takes card LOCAL_RANK (or its rank)
    modulo the cards present. ``device="cuda"`` with no GPU present raises
    (``utils.resolve_device``); the CPU is taken only when asked for. Does
    nothing when the group exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("init_distributed: an explicit init_method needs world_size and rank")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(default_backend(dev, world_size), init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def build_mesh(tensor: Optional[int] = None, data: int = 1, device=None, inner: str = "tensor") -> Mesh:
    """The (data, tensor) mesh over every rank of the default group (which
    must exist: ``init_distributed``). Every rank must call it, in the same
    order as any other group it makes. ``device``: the rank's device, the
    card by default (its current one), which raises when no GPU is present;
    pass "cpu" for the CPU. ``inner`` names the inner axis: "seq" makes gate
    training's (data, seq) mesh, whose seq size is ``tensor``."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: call init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    tensor = world // data if tensor is None else tensor
    if tensor < 1 or data < 1 or tensor * data != world:
        raise ValueError(f"build_mesh: tensor {tensor} x data {data} != {world} ranks")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    data_rank, tensor_rank = divmod(rank, tensor)
    tensor_group = data_group = None
    for d in range(data):  # every rank makes every group, in one order
        group = dist.new_group([d * tensor + t for t in range(tensor)], timeout=timeout)
        tensor_group = group if d == data_rank else tensor_group
    for t in range(tensor):
        group = dist.new_group([d * tensor + t for d in range(data)], timeout=timeout)
        data_group = group if t == tensor_rank else data_group
    return Mesh(tensor=tensor, data=data, rank=rank, tensor_rank=tensor_rank, data_rank=data_rank,
                tensor_group=tensor_group, data_group=data_group, tensor_src=data_rank * tensor,
                backend=dist.get_backend(), device=dev, inner=inner)


# ---------------------------------------------------------------------------
# Collectives (counted: ops/launches.py)
# ---------------------------------------------------------------------------


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum", group: str = "tensor") -> torch.Tensor:
    """In-place all_reduce of t over the rank's tensor group (or the group of
    another axis, ``Mesh.axis``: "data", "seq", "world"), ``op`` "sum" or
    "max"; returns t."""
    dist.all_reduce(t, op=_OPS[op], group=mesh.axis(group).group)
    if op == "sum":
        all_reduce.sum_calls += 1
    else:
        all_reduce.max_calls += 1
    return t


all_reduce.sum_calls = 0
all_reduce.max_calls = 0


def sum_across(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the tensor group, taken in float32 (gloo and NCCL
    alike), cast back to t's dtype. t itself is left alone unless float32."""
    if t.dtype == torch.float32:
        return all_reduce(mesh, t)
    return all_reduce(mesh, t.float()).to(t.dtype)


def every_group(mesh: Mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on every data group (an all_reduce MAX of its
    negation over the data group; ``flag`` itself at data 1). A host loop
    whose exit depends on the group's own rows asks this, so that every
    group leaves it at the same iteration and the collectives after it pair
    up."""
    if mesh.data == 1:
        return flag
    t = torch.tensor([0.0 if flag else 1.0], device=mesh.device)
    return float(all_reduce(mesh, t, "max", group="data")) == 0.0


def broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """In-place broadcast of t from tensor-rank 0 over the tensor group."""
    dist.broadcast(t, src=mesh.tensor_src, group=mesh.tensor_group)
    broadcast.calls += 1
    return t


broadcast.calls = 0


def all_to_all(axis: Axis, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all`` over ``axis``: x's ``split_dim`` is cut
    into axis.size chunks, chunk j goes to the axis's rank j, and the chunks
    received are joined along ``concat_dim`` in rank order. An axis of one
    rank returns x."""
    P = axis.size
    if P == 1:
        return x
    chunks = x.unflatten(split_dim, (P, -1)).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=axis.group)
    all_to_all.calls += 1
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


all_to_all.calls = 0


def all_gather(axis: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_gather``: every rank's x joined along ``dim`` in
    the axis's rank order. An axis of one rank returns x."""
    if axis.size == 1:
        return x
    send = x.contiguous()
    parts = [torch.empty_like(send) for _ in range(axis.size)]
    dist.all_gather(parts, send, group=axis.group)
    all_gather.calls += 1
    return torch.cat(parts, dim=dim)


all_gather.calls = 0


def axis_sum(axis: Axis, t: torch.Tensor) -> torch.Tensor:
    """In-place SUM of t over ``axis`` (nothing on an axis of one rank)."""
    return t if axis.size == 1 else all_reduce(axis.mesh, t, group=axis.name)


def train_collectives() -> Dict[str, int]:
    """Gate training's collective calls so far: all_to_all, all_gather and
    the all_reduce SUMs (the counter shared with inference)."""
    return {"all_to_all": all_to_all.calls, "all_gather": all_gather.calls, "all_reduce.sum": all_reduce.sum_calls}


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerShard:
    """One layer on one rank: whether its attention is head-sharded, the
    global KV heads it holds (its full ones, then its streaming ones), and
    whether its MLP (dense or expert) is split."""

    sharded: bool
    full: Tuple[int, ...]
    stream: Tuple[int, ...]
    mlp: bool

    @property
    def hf(self) -> int:
        return len(self.full)

    @property
    def hs(self) -> int:
        return len(self.stream)

    @property
    def kv(self) -> Tuple[int, ...]:
        return self.full + self.stream


@dataclasses.dataclass(frozen=True)
class Plan:
    """The rank's whole layout: one LayerShard a layer, whether the vocab is
    split, and the rank's vocab rows [vocab_start, vocab_start + vocab_rows)."""

    layers: Tuple[LayerShard, ...]
    vocab: bool
    vocab_start: int
    vocab_rows: int


def _own(n: int, tp: int, r: int, base: int = 0) -> Tuple[int, ...]:
    k = n // tp
    return tuple(range(base + r * k, base + (r + 1) * k))


def mlp_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether the MLP splits over tp ranks: the experts of a MoE model
    (X % tp == 0), else the intermediate width."""
    n = cfg.num_local_experts if cfg.num_local_experts > 0 else cfg.intermediate_size
    return n % tp == 0


def layer_shards(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig) -> Tuple[LayerShard, ...]:
    """The rank's per-layer head plan."""
    from .spmd import can_shard_heads

    tp, r = mesh.tensor, mesh.tensor_rank
    mlp = mlp_split(cfg, tp)
    out = []
    for hf in duo.num_full_kv_heads:
        hs = cfg.num_kv_heads - hf
        if can_shard_heads(mesh, hf) and can_shard_heads(mesh, hs):
            out.append(LayerShard(True, _own(hf, tp, r), _own(hs, tp, r, hf), mlp))
        else:
            out.append(LayerShard(False, tuple(range(hf)), tuple(range(hf, hf + hs)), mlp))
    return tuple(out)


def plan_for(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig) -> Plan:
    """The rank's Plan."""
    return Plan(layer_shards(mesh, cfg, duo), *vocab_shard(mesh, cfg))


def vocab_shard(mesh: Mesh, cfg: ModelConfig) -> Tuple[bool, int, int]:
    """(whether the vocab splits, the rank's first row, its rows) of the
    embedding and the head."""
    tp, V = mesh.tensor, cfg.vocab_size
    if V % tp:
        return False, 0, V
    return True, mesh.tensor_rank * (V // tp), V // tp


def _q_rows(kv: Sequence[int], G: int, D: int) -> List[int]:
    """Rows of wq (and columns of wo) of the query heads of KV heads kv."""
    return [h * D + d for k in kv for h in range(k * G, (k + 1) * G) for d in range(D)]


def _kv_rows(kv: Sequence[int], D: int) -> List[int]:
    return [k * D + d for k in kv for d in range(D)]


def _take(t: torch.Tensor, dim: int, idx: Sequence[int]) -> torch.Tensor:
    """t's entries ``idx`` along ``dim``, as a tensor of its own (t itself
    when idx is all of it, in order)."""
    if list(idx) == list(range(t.shape[dim])):
        return t
    return t.index_select(dim, torch.as_tensor(list(idx), dtype=torch.long, device=t.device))


def _base(key: str) -> str:
    for suffix in ("_q8", "_scale"):
        if key.endswith(suffix):
            return key[: -len(suffix)]
    return key


def shard_layer(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, li: int, layer: Dict) -> Dict:
    """Layer ``li``'s rank-local params: key-driven, as ``shardings_like``
    (``*_q8`` and ``*_scale`` follow their weight, except a row split's
    scale, which is per output channel and stays whole; ``experts_w*`` split
    over the expert axis; ``bq``/``bk``/``bv`` with their heads). Any other
    key stays whole."""
    s = plan_for(mesh, cfg, duo).layers[li]
    G, D, tp, r = cfg.num_kv_groups, cfg.head_dim, mesh.tensor, mesh.tensor_rank
    q_rows, kv_rows = _q_rows(s.kv, G, D), _kv_rows(s.kv, D)
    out = {}
    for key, t in layer.items():
        base = _base(key)
        if base in ("wq", "bq"):
            out[key] = _take(t, 0, q_rows)
        elif base in ("wk", "wv", "bk", "bv"):
            out[key] = _take(t, 0, kv_rows)
        elif base == "wo" and not key.endswith("_scale"):
            out[key] = _take(t, 1, q_rows)
        elif s.mlp and base in ("w_gate", "w_up"):
            out[key] = _take(t, 0, _own(t.shape[0], tp, r))
        elif s.mlp and base == "w_down" and not key.endswith("_scale"):
            out[key] = _take(t, 1, _own(t.shape[1], tp, r))
        elif s.mlp and key.startswith("experts_w"):
            out[key] = _take(t, 0, _own(t.shape[0], tp, r))
        else:
            out[key] = t
    return out


_VOCAB_KEYS = ("embed", "embed_q8", "embed_scale", "lm_head", "lm_head_q8", "lm_head_scale")


def shard_top(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, top: Dict) -> Dict:
    """The rank-local params outside the layers: the vocab rows of the
    embedding and the head (and their scales) when the vocab splits."""
    plan = plan_for(mesh, cfg, duo)
    rows = range(plan.vocab_start, plan.vocab_start + plan.vocab_rows)
    return {key: (_take(t, 0, rows) if plan.vocab and key in _VOCAB_KEYS else t) for key, t in top.items()}


def sharder(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig) -> Callable[[Optional[int], Dict], Dict]:
    """``shard(layer index or None, part) -> rank-local part``: the hook the
    model builders (``init_params``, ``init_params_w8a8``,
    ``init_params_w8a8_random``) apply to each layer and to the top as they
    draw it, so no rank holds the whole model."""
    return lambda li, part: shard_top(mesh, cfg, duo, part) if li is None else shard_layer(mesh, cfg, duo, li, part)


def shard_params(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, params: Dict) -> Dict:
    """The rank-local params of a full param dict (bf16, float32 or W8A8)."""
    top = shard_top(mesh, cfg, duo, {k: v for k, v in params.items() if k != "layers"})
    top["layers"] = [shard_layer(mesh, cfg, duo, li, layer) for li, layer in enumerate(params["layers"])]
    return top


def check_sharded(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, params: Dict) -> None:
    """Raise unless ``params`` are this rank's slices (``shard_params``)."""
    plan = plan_for(mesh, cfg, duo)
    for li, (layer, s) in enumerate(zip(params["layers"], plan.layers)):
        wk = layer["wk_q8"] if "wk_q8" in layer else layer["wk"]
        if wk.shape[0] != len(s.kv) * cfg.head_dim:
            raise ValueError(f"layer {li}: wk has {wk.shape[0]} rows, the rank's plan {len(s.kv)} KV heads of "
                             f"{cfg.head_dim}: pass shard_params(mesh, cfg, duo, params)")
    for key in _VOCAB_KEYS:
        if key in params and params[key].shape[0] != plan.vocab_rows:
            raise ValueError(f"{key} has {params[key].shape[0]} rows, the rank's plan {plan.vocab_rows}")


@dataclasses.dataclass(frozen=True)
class CacheShards:
    """A rank's cache: per-layer (full, streaming) KV head counts and its
    batch rows [batch_start, batch_start + batch)."""

    heads: Tuple[Tuple[int, int], ...]
    batch: int
    batch_start: int


def batch_split(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """(rows, first row) of the rank's slice of a batch: split over the data
    groups when it divides, else the whole batch on every group."""
    if mesh.data > 1 and batch_size % mesh.data == 0:
        b = batch_size // mesh.data
        return b, mesh.data_rank * b
    return batch_size, 0


def cache_shardings(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, batch_size: int) -> CacheShards:
    """The rank's cache layout (counterpart of JAX's ``cache_shardings``): its
    KV heads of every layer and its batch rows."""
    b, start = batch_split(mesh, batch_size)
    return CacheShards(tuple((s.hf, s.hs) for s in plan_for(mesh, cfg, duo).layers), b, start)


def shard_cache(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, cache):
    """The rank's slice of a full DuoCache or DuoCacheQ4: its batch rows and,
    in each layer, its KV heads (full buffers by full head, streaming buffers
    by streaming head)."""
    plan = plan_for(mesh, cfg, duo)
    b, start = batch_split(mesh, getattr(cache, cache.BUFFERS[0])[0].shape[0])
    rows = range(start, start + b)
    bufs = {}
    for name in cache.BUFFERS:
        per_layer = []
        for li, (t, s) in enumerate(zip(getattr(cache, name), plan.layers)):
            # a streaming buffer holds the layer's streaming heads from 0
            heads = s.full if "full" in name else [k - duo.num_full_kv_heads[li] for k in s.stream]
            per_layer.append(_take(_take(t, 0, rows), 1, heads).clone())
        bufs[name] = per_layer
    length = cache.length[start : start + b].clone() if cache.length.dim() else cache.length.clone()
    return type(cache)(**bufs, length=length)


def shard_inference_state(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, params: Dict, cache):
    """(rank-local params, rank-local cache) of full ones."""
    return shard_params(mesh, cfg, duo, params), shard_cache(mesh, cfg, duo, cache)


def gather_rows(mesh: Mesh, local: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The whole batch from the data groups' row slices (``batch_split``),
    through a zero-padded all_reduce over the data group. A batch that is not
    split comes back as it is."""
    b, start = batch_split(mesh, batch_size)
    if b == batch_size:
        return local
    full = local.new_zeros((batch_size, *local.shape[1:]))
    full[start : start + b] = local
    return all_reduce(mesh, full, group="data")


def collectives_per_step(mesh: Mesh, cfg: ModelConfig, duo: DuoConfig, w8a8: bool) -> Dict[str, int]:
    """The collectives of one decode step of ``DuoEngine`` on one rank
    (greedy, a batch that needs no gather): an all_reduce SUM after wo in
    every head-sharded layer and after the MLP in every layer when it splits
    (each row-split W8A8 product adds an all_reduce MAX of its activation
    scale; a MoE layer's experts stay bf16), one each for the embedding and
    the head when the vocab splits, and the token's broadcast."""
    plan = plan_for(mesh, cfg, duo)
    moe = cfg.num_local_experts > 0
    wo = sum(s.sharded for s in plan.layers)
    mlp = sum(s.mlp for s in plan.layers)
    return {"all_reduce.sum": wo + mlp + 2 * plan.vocab,
            "all_reduce.max": (wo + (0 if moe else mlp)) if w8a8 else 0,
            "broadcast": 1}


@contextlib.contextmanager
def rank_output_dir(mesh: Mesh, path: str):
    """Where this rank writes an eval's results, for the ``with`` block:
    ``path`` on global rank 0; on every other rank a private copy of what
    ``path`` holds now (removed afterwards), so that resuming skips the same
    work on every rank while only rank 0 writes. Entering ends with a
    barrier (an all_reduce over the rank's groups)."""
    private = None
    if mesh.rank != 0:
        private = tempfile.mkdtemp(prefix=f"rank{mesh.rank}_")
        if os.path.isdir(path):
            for name in os.listdir(path):
                if os.path.isfile(os.path.join(path, name)):
                    shutil.copy(os.path.join(path, name), os.path.join(private, name))
    token = torch.zeros(1, device=mesh.device)
    all_reduce(mesh, token)
    all_reduce(mesh, token, group="data")
    try:
        yield path if private is None else private
    finally:
        if private is not None:
            shutil.rmtree(private, ignore_errors=True)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------


def _rank_entry(fn, rank: int, tensor: int, data: int, device: str, init_method: str, args: tuple,
                results, inner: str = "tensor") -> None:
    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        init_distributed(init_method, tensor * data, rank, device)
        mesh = build_mesh(tensor, data, device=device, inner=inner)
        results.put((rank, True, fn(mesh, *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, tensor: int, data: int = 1, args: tuple = (), *, device="cuda",
              timeout_s: float = 600.0, store_dir: Optional[str] = None, inner: str = "tensor") -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``tensor * data`` new processes (start
    method ``spawn``), one rank each, and return their results by rank.
    ``inner="seq"`` makes the mesh gate training's (data, seq), seq size
    ``tensor``.

    ``fn`` must be importable by name (a module-level function of this
    package: a spawned child imports it, and must not import a test module
    or JAX). The ranks meet through a ``file://`` store in a fresh directory
    under ``store_dir`` (the system's temporary directory by default), so
    concurrent runs never share a port. ``device``: "cpu", or "cuda" (each
    rank its own card under NCCL; gloo when they share one). Each rank runs
    one intra-op thread. A rank that raises fails the run: its
    traceback is re-raised here and every other rank is killed; so is every
    rank after ``timeout_s`` seconds (a hang), with a TimeoutError."""
    import torch.multiprocessing as mp

    world = tensor * data
    resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, tensor, data, str(device), init_method, args, results, inner))
                 for r in range(world)]
        for p in procs:
            p.start()
        done: Dict[int, Any] = {}
        failed: Dict[int, str] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(done) + len(failed) < world and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks({fn.__name__}): ranks {sorted(set(range(world)) - set(done))} "
                                       f"did not finish in {timeout_s:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):  # a rank that died without a word (killed, crashed)
                        if p.exitcode not in (None, 0) and r not in done and r not in failed:
                            time.sleep(1.0)  # its message may still be in the pipe
                            if results.empty():
                                failed[r] = f"rank {r} exited with code {p.exitcode}"
                    continue
                (done if ok else failed)[rank] = payload
        finally:
            for p in procs:  # ranks that reported exit at once; the others are stuck
                p.join(timeout=30.0 if len(done) == world else 2.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"run_ranks({fn.__name__}): rank {rank} failed:\n{failed[rank]}")
    return [done[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Dry runs: TP against the one-device path, on new ranks
# ---------------------------------------------------------------------------

# On the card the ranks run bf16 through the kernels, whose attention takes
# head_dim 64 or 128, and a bf16 reduction order may turn a near-tie: tokens
# must agree up to the unsharded run's first top-2 logit gap below this.
# On the CPU (float32, the plain versions) they must agree outright.
DRYRUN_NEAR_TIE = 0.25


def _dryrun_setup(device):
    """JAX dryrun_step's GQA-free tiny config (head_dim 64 on the card, as
    its kernels need), its heterogeneous split (4, 8) and the dtype."""
    cuda = torch.device(device).type == "cuda"
    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=8,
                      num_kv_heads=8, head_dim=64 if cuda else 16, model_type="llama")
    duo = DuoConfig(sink_size=8, recent_size=16, num_full_kv_heads=(4, 8), max_cache_size=256,
                    prefill_chunk_size=32)
    return cfg, duo, (torch.bfloat16 if cuda else torch.float32)


def _greedy_gaps(engine, prompt, n: int):
    """An engine's greedy tokens [B, n] from eager decode steps, and the
    top-2 logit gap before each (the smallest over the batch). Under a mesh
    every rank of it calls this, with a batch that is not split."""
    from ..models import llama

    cache, logits = engine.prefill(prompt)
    tokens, gaps = [], []
    for t in range(n):
        top = logits.float().topk(2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        tok = engine._agree(torch.argmax(logits, dim=-1))
        tokens.append(tok)
        if t + 1 < n:
            with torch.no_grad():
                hidden, cache = llama.forward_chunk(engine.params, engine.cfg, engine.duo, cache, tok[:, None], 1,
                                                    full_bucket=engine.bucket_for(prompt.shape[1] + n),
                                                    mesh=engine.mesh)
                logits = llama.logits_at(engine.params, hidden, 0, mesh=engine.mesh, cfg=engine.cfg)
    return torch.stack(tokens, dim=1).cpu().numpy(), gaps


def _agree_until_tie(got, want, gaps, near_tie: float, label: str) -> int:
    """Assert the streams agree up to the first near-tie; return how far."""
    differ = np.nonzero((np.asarray(got) != np.asarray(want)).any(axis=0))[0]
    first = int(differ[0]) if len(differ) else got.shape[1]
    tie = next((t for t, g in enumerate(gaps) if g < near_tie), len(gaps))
    if first < min(tie, got.shape[1]):
        raise AssertionError(f"{label}: tp-sharded tokens diverged from one device at step {first} (first "
                             f"near-tie at {tie}):\n{got} vs {want}")
    return first


def _dry_step(mesh: Mesh, device) -> dict:
    """One chunk step of the tp x dp mesh and of an expert-parallel Mixtral
    (4 experts): logits of the right shape, finite, and on the CPU equal to
    the one-device step's (float32)."""
    from ..cache import init_cache
    from ..models import llama

    cfg, duo, dtype = _dryrun_setup(device)
    out = {}
    for label, c in (("dense", cfg), ("moe", dataclasses.replace(cfg, model_type="mixtral", num_local_experts=4,
                                                                  num_experts_per_tok=2))):
        params = llama.init_params(c, seed=0 if label == "dense" else 1, dtype=dtype, device=device)
        batch = mesh.data
        ids = torch.as_tensor(np.random.default_rng(4).integers(0, c.vocab_size, (batch, duo.prefill_chunk_size)),
                              device=device)
        with torch.no_grad():
            hidden, _ = llama.forward_chunk(params, c, duo, init_cache(c, duo, batch, dtype, device), ids)
            want = llama.logits_at(params, hidden, ids.shape[1] - 1)
            shards = cache_shardings(mesh, c, duo, batch)
            local = shard_params(mesh, c, duo, params)
            cache = init_cache(c, duo, shards.batch, dtype, device, heads=shards.heads)
            rows = ids[shards.batch_start : shards.batch_start + shards.batch]
            hidden, _ = llama.forward_chunk(local, c, duo, cache, rows, mesh=mesh)
            got = gather_rows(mesh, llama.logits_at(local, hidden, ids.shape[1] - 1, mesh=mesh, cfg=c), batch)
        if tuple(got.shape) != (batch, c.vocab_size) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} step: logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        err = float((got - want).abs().max())
        if torch.device(device).type == "cpu" and err > 1e-4:
            raise AssertionError(f"{label} step: tp logits differ from one device by {err}")
        out[label] = err
    return out


def _dry_tp_equivalence(mesh: Mesh, device, cfg=None, duo=None) -> dict:
    """16 greedy tokens of the tp-sharded engine == the one-device engine's
    (JAX ``dryrun_tp_equivalence``; on the card up to a near-tie)."""
    from ..engine import DuoEngine
    from ..models import llama

    base_cfg, base_duo, dtype = _dryrun_setup(device)
    cfg, duo = cfg or base_cfg, duo or base_duo
    params = llama.init_params(cfg, seed=2, dtype=dtype, device=device)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 48))
    want, gaps = _greedy_gaps(DuoEngine(params, cfg, duo, dtype=dtype, device=device), prompt, 16)
    eng = DuoEngine(shard_params(mesh, cfg, duo, params), cfg, duo, dtype=dtype, device=device, mesh=mesh)
    got, _ = eng.generate(prompt, max_new_tokens=16)
    near_tie = DRYRUN_NEAR_TIE if torch.device(device).type == "cuda" else 0.0
    return {"agree": _agree_until_tie(got, want, gaps, near_tie, "tp_equivalence"), "tokens": got.tolist()}


def _dry_tp_niah_cell(mesh: Mesh, device) -> dict:
    """One NIAH cell of the constructed circuit with its trained pattern
    (artifacts/accuracy_loop/pattern, sparsity 0.5): the tp-sharded engine's
    response equals the one-device engine's, and both retrieve the needle
    (JAX ``dryrun_tp_niah_cell``)."""
    from ..engine import DuoEngine
    from ..evals.accuracy_loop import _cast_floats
    from ..evals.niah import NIAHConfig, NIAHTester
    from ..models.constructed import BASE_SPEC, build_params
    from ..models.convert import reorder_params
    from ..patterns import load_attn_pattern, sparsify_attention_heads
    from ..tokenizer import get_tokenizer
    from ..train.data import _CODE_WORDS, _NAMES

    pattern_dir = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts", "accuracy_loop", "pattern")
    tok = get_tokenizer("word")
    cfg = BASE_SPEC.model_config()
    heads, sink, recent = load_attn_pattern(pattern_dir)
    binary, _ = sparsify_attention_heads(heads, sparsity=0.5)
    params, nf = reorder_params(build_params(tok, spec=BASE_SPEC, device=device), cfg, binary)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    params = _cast_floats(params, dtype)
    duo = DuoConfig(sink_size=int(sink), recent_size=int(recent), num_full_kv_heads=tuple(nf),
                    max_cache_size=8192, prefill_chunk_size=1024)
    name, code = _NAMES[3], " ".join(_CODE_WORDS[4:7])
    needle = dict(needle=f" Remember this: the secret code of {name} is {code}. ",
                  question=f"\nQuestion: the secret code of {name} is", answer=code,
                  gen_tokens=len(code.split()) + 2)
    responses = []
    for engine in (DuoEngine(params, cfg, duo, dtype=dtype, device=device),
                   DuoEngine(shard_params(mesh, cfg, duo, params), cfg, duo, dtype=dtype, device=device, mesh=mesh)):
        with tempfile.TemporaryDirectory() as out:
            config = NIAHConfig(context_lengths=[4096], depth_percents=[50.0], output_dir=out, resume=False,
                                **needle)
            responses.append(NIAHTester(engine, tok, config).run_cell(4096, 50.0))
    one, tp = responses
    if one["response"] != tp["response"] or one["word_overlap"] != 1.0:
        raise AssertionError(f"tp_niah_cell: one device {one}, tp {tp}")
    return {"response": tp["response"], "word_overlap": tp["word_overlap"]}


def _dry_serving_tp(mesh: Mesh, device) -> dict:
    """Continuous batching on the (data x tensor) mesh: four mixed-length
    requests through a 2-slot ServingEngine (the pool's slots split over the
    data groups, its KV heads over the tensor ranks) give each request the
    one-device engine's tokens (JAX ``dryrun_serving_tp``; on the card up to
    a near-tie)."""
    from ..engine import DuoEngine
    from ..models import llama
    from ..serving import Request, ServingEngine

    cfg, duo, dtype = _dryrun_setup(device)
    params = llama.init_params(cfg, seed=5, dtype=dtype, device=device)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in (17, 50, 33, 70)]
    serve = ServingEngine(shard_params(mesh, cfg, duo, params), cfg, duo, max_batch_size=2, dtype=dtype,
                          device=device, decode_burst=3, mesh=mesh)
    for i, p in enumerate(prompts):
        serve.submit(Request(rid=i, prompt_ids=p, max_new_tokens=6))
    finished = {r.rid: r.generated for r in serve.run()}
    near_tie = DRYRUN_NEAR_TIE if torch.device(device).type == "cuda" else 0.0
    one = DuoEngine(params, cfg, duo, dtype=dtype, device=device)
    for i, p in enumerate(prompts):
        want, gaps = _greedy_gaps(one, p[None], 6)
        _agree_until_tie(np.asarray([finished[i]]), want, gaps, near_tie, f"serving_tp request {i}")
    return {"tokens": finished}


def _dry_pipeline(mesh: Mesh, device) -> dict:
    """JAX dryrun_step's pipeline step: 2 balanced layer stages
    (``parallel/pipeline.py``; both on the rank's device) generate the
    one-device engine's tokens from a zero prompt of one chunk (on the card
    up to a near-tie)."""
    from ..engine import DuoEngine
    from ..models import llama
    from .pipeline import PipelinedEngine

    cfg, duo, dtype = _dryrun_setup(device)
    params = llama.init_params(cfg, seed=0, dtype=dtype, device=device)
    prompt = np.zeros((1, duo.prefill_chunk_size), np.int64)
    want, gaps = _greedy_gaps(DuoEngine(params, cfg, duo, dtype=dtype, device=device), prompt, 2)
    got, caches = PipelinedEngine(params, cfg, duo, devices=[mesh.device] * 2, dtype=dtype).generate(prompt, 2)
    if got.shape != (1, 2) or [int(c.length) for c in caches] != [duo.prefill_chunk_size + 2] * 2:
        raise AssertionError(f"pipeline step: tokens {got.shape}, stage lengths {[int(c.length) for c in caches]}")
    near_tie = DRYRUN_NEAR_TIE if torch.device(device).type == "cuda" else 0.0
    return {"agree": _agree_until_tie(got, want, gaps, near_tie, "pipeline"), "tokens": got.tolist()}


def _dry_train(mesh: Mesh, device) -> dict:
    """JAX dryrun_step's training step on the same ranks seen as a (data, seq)
    mesh (``train/trainer.py``'s dry-run model; sp = the tensor size)."""
    from ..train.trainer import _dryrun_train_rank

    out = _dryrun_train_rank(dataclasses.replace(mesh, inner="seq"), device, tempfile.mkdtemp(prefix="dryrun_train_"))
    out["gates"] = out["gates"].tolist()
    return out


_DRY = {"step": _dry_step, "tp_equivalence": _dry_tp_equivalence, "tp_niah_cell": _dry_tp_niah_cell,
        "serving_tp": _dry_serving_tp, "pipeline": _dry_pipeline, "train": _dry_train}


def _dryrun_rank(mesh: Mesh, checks: Sequence[str], device, extra: tuple = ()) -> dict:
    """Run the named dry-run checks on this rank; rank 0's results come back."""
    return {name: _DRY[name](mesh, device, *extra) for name in checks}


def _dryrun(checks, tensor: int, data: int, device, extra=(), **kw) -> dict:
    results = run_ranks(_dryrun_rank, tensor, data, args=(tuple(checks), str(device), extra), device=device, **kw)
    for name in checks:
        print(f"[dryrun] {name}: tp={tensor} x data={data} == one device on {device}: {results[0][name]}", flush=True)
    return results[0]


def dryrun_step(n_devices: int, device="cuda", **kw) -> dict:
    """Every dry run of JAX's ``dryrun_step`` on ``n_devices`` new ranks, one
    spawn: the tp x dp chunk step and the expert-parallel step, then
    ``dryrun_tp_equivalence``, ``dryrun_tp_niah_cell`` and (with 4 ranks or
    more) ``dryrun_serving_tp`` on the same (data, tensor) mesh (data 2 when
    ``n_devices`` is a multiple of 4, else 1), the pipeline step (2 stages on
    each rank's device) and the gate-training step on the same ranks as a
    (data, seq) mesh. JAX's last step, ``dryrun_1m_decode``, is a spawn of
    its own (a 1M-token cache). ``kw`` goes to ``run_ranks``."""
    data = 2 if n_devices % 4 == 0 else 1
    checks = ["step", "tp_equivalence"]
    if n_devices // data >= 2:
        checks.append("tp_niah_cell")
    if data == 2:
        checks.append("serving_tp")
    checks += ["pipeline", "train"]
    return _dryrun(checks, n_devices // data, data, device, **kw)


def dryrun_tp_equivalence(n_devices: int, cfg=None, duo=None, device="cuda", **kw) -> dict:
    """tp = min(4, n_devices) generation == one device (16 greedy tokens)."""
    return _dryrun(["tp_equivalence"], min(4, n_devices), 1, device, extra=(cfg, duo), **kw)


def dryrun_tp_niah_cell(n_devices: int, device="cuda", **kw) -> Optional[dict]:
    """The trained-pattern NIAH cell at tp = 2 (the circuit's 2 retrieval
    heads split over 2 ranks); nothing below 2 devices."""
    if n_devices < 2:
        return None
    return _dryrun(["tp_niah_cell"], 2, 1, device, **kw)


def dryrun_serving_tp(n_devices: int, device="cuda", **kw) -> Optional[dict]:
    """The ServingEngine on a (data 2 x tensor 2) mesh; nothing below 4
    devices."""
    if n_devices < 4:
        return None
    return _dryrun(["serving_tp"], 2, 2, device, **kw)


def _1m_setup(tensor: int, ctx: int, device):
    """JAX ``dryrun_1m_decode``'s model (2 layers, 8 KV heads of head_dim 128,
    hidden 1,024), its split (``tensor`` full heads a layer: sparsity 0.5 at
    TP = 4), the INT4 cache's span and the activations' dtype (float32 on
    the CPU, bf16 on the card)."""
    cfg = ModelConfig(vocab_size=512, hidden_size=1024, intermediate_size=2048, num_layers=2, num_heads=8,
                      num_kv_heads=8, head_dim=128, model_type="llama")
    duo = DuoConfig(sink_size=64, recent_size=256, num_full_kv_heads=(tensor,) * cfg.num_layers,
                    max_cache_size=ctx, prefill_chunk_size=512)
    return cfg, duo, (torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32)


def kv_bytes_reckoned(cfg: ModelConfig, duo: DuoConfig, heads, batch: int, q4: bool, dtype) -> int:
    """A chunked-prefill cache's bytes from its shapes and per-layer (full,
    streaming) head counts: an INT4 full head a byte a channel a token pair
    and four bf16 scale rows a pair (a bf16/float full head the dtype's bytes
    a channel a token), K and V; a streaming head its sink + chunk rows and
    round_up(recent + chunk, 512) ring rows."""
    T, D, C = duo.max_cache_size, cfg.head_dim, duo.prefill_chunk_size
    size = torch.tensor([], dtype=dtype).element_size()
    full = (T // 2) * (D + 4 * 2) if q4 else T * D * size
    stream = (duo.sink_size + C + -(-(duo.recent_size + C) // 512) * 512) * D * size
    return sum(2 * batch * (hf * full + hs * stream) for hf, hs in heads)


def _dry_1m_rank(mesh: Mesh, ctx: int, device) -> dict:
    """One decode step against a true ``ctx``-token INT4 cache (its length
    ctx - 8), head-sharded over the rank's tensor group: W8A8 weights with
    int8 embeddings, built as the rank's slices (``sharder``), kernels on the
    card. The logits (whole on every rank) must be finite and the rank's KV
    bytes equal their reckoning."""
    from ..cache import init_cache_q4, kv_memory_bytes
    from ..models import llama
    from ..ops.quant import init_params_w8a8

    from ..ops import launches

    cfg, duo, dtype = _1m_setup(mesh.tensor, ctx, device)
    params = init_params_w8a8(cfg, seed=0, dtype=dtype, device=device, quantize_embeds=True,
                              shard=sharder(mesh, cfg, duo))
    before = launches.snapshot()
    shards = cache_shardings(mesh, cfg, duo, 1)
    cache = init_cache_q4(cfg, duo, 1, dtype, device, heads=shards.heads)
    cache.length.fill_(ctx - 8)
    with torch.no_grad():
        hidden, cache = llama.forward_chunk(params, cfg, duo, cache, torch.zeros((1, 1), dtype=torch.long,
                                                                                  device=device),
                                            1, full_bucket=ctx, mesh=mesh)
        logits = llama.logits_at(params, hidden, 0, mesh=mesh, cfg=cfg).float()
    step = {name: a - b for name, a, b in zip(launches.counters(), launches.snapshot(), before) if a != b}
    kv, reckoned = kv_memory_bytes(cache), kv_bytes_reckoned(cfg, duo, shards.heads, 1, True, dtype)
    if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"1M decode: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    if kv != reckoned or int(cache.length) != ctx - 7:
        raise AssertionError(f"1M decode: KV {kv} bytes, reckoned {reckoned}; length {int(cache.length)}")
    return {"logits": logits.cpu().numpy(), "kv_bytes": kv, "kv_bytes_reckoned": reckoned, "heads": shards.heads,
            "launches": step}


def one_process_1m_logits(ctx: int, tensor: int = 4, device="cuda") -> np.ndarray:
    """``dryrun_1m_decode``'s step in this process, with no mesh: the whole
    params (the same draws) and a whole cache of the same length."""
    from ..cache import init_cache_q4
    from ..models import llama
    from ..ops.quant import init_params_w8a8

    cfg, duo, dtype = _1m_setup(tensor, ctx, device)
    params = init_params_w8a8(cfg, seed=0, dtype=dtype, device=device, quantize_embeds=True)
    cache = init_cache_q4(cfg, duo, 1, dtype, device)
    cache.length.fill_(ctx - 8)
    with torch.no_grad():
        hidden, _ = llama.forward_chunk(params, cfg, duo, cache, torch.zeros((1, 1), dtype=torch.long, device=device),
                                        1, full_bucket=ctx)
        return llama.logits_at(params, hidden, 0).float().cpu().numpy()


def dryrun_1m_decode(n_devices: int, ctx: int = 1 << 20, device="cuda", **kw) -> dict:
    """One decode step against a true 1M-token INT4 KV cache, head-sharded
    over TP = min(4, n_devices) new ranks (JAX ``dryrun_1m_decode``: the
    reference reaches 1M with 8-GPU tensor parallelism,
    scripts/run_niah.sh:2-8). The KV geometry is real (8 KV heads of
    head_dim 128 over 1,048,576 slots, INT4, 1 full and 1 streaming head a
    layer on each of 4 ranks); depth and width are cut. Rank 0's logits, and
    every rank's KV bytes (each equal to its reckoning) and the kernel
    launches and collectives of its step (``ops/launches.py``'s counters).
    ``kw`` goes to ``run_ranks``."""
    tensor = min(4, n_devices)
    ranks = run_ranks(_dry_1m_rank, tensor, 1, args=(ctx, str(device)), device=device, **kw)
    kv = [r["kv_bytes"] for r in ranks]
    print(f"[dryrun] {ctx}-token sharded decode ok: tp={tensor}, KV {sum(kv) / 1e9:.3f} GB in all, "
          f"{kv[0] / 1e9:.3f} GB a rank (2 layers; x16 for 32)", flush=True)
    return {"logits": ranks[0]["logits"], "kv_bytes": kv, "kv_bytes_reckoned": [r["kv_bytes_reckoned"] for r in ranks],
            "launches": [r["launches"] for r in ranks], "tensor": tensor, "ctx": ctx}


# ---------------------------------------------------------------------------
# Rank jobs: what tests and scripts run on spawned ranks (run_ranks(run_jobs, ...))
# ---------------------------------------------------------------------------


def run_jobs(mesh: Mesh, jobs: Sequence[tuple]) -> list:
    """Run ``jobs`` in order on this rank and return their results: each
    job is ``(fn, args, kwargs)``, called as ``fn(mesh, *args, **kwargs)``
    (a module-level function, so that a spawned rank can import it), or
    ``(fn, args, kwargs, False)`` to call ``fn(*args, **kwargs)`` without
    the mesh."""
    out = []
    for job in jobs:
        fn, args, kwargs = job[:3]
        with_mesh = job[3] if len(job) > 3 else True
        out.append(fn(mesh, *args, **kwargs) if with_mesh else fn(*args, **kwargs))
    return out


def stream_logits(engine, prompt, stream) -> np.ndarray:
    """An engine's logits before each token of ``stream`` [B, n] fed after
    ``prompt`` [B, S] (teacher-forced eager steps on a new cache), float32
    [n, B, vocab] of the whole batch. Under a mesh every rank of it calls
    this."""
    from ..models import llama

    cache, logits = engine.prefill(engine.local_rows(prompt))
    out = [logits.float()]
    bucket = engine.bucket_for(prompt.shape[1] + stream.shape[1])
    rows = engine.local_rows(stream)
    with torch.no_grad():
        for t in range(stream.shape[1] - 1):
            tok = torch.as_tensor(rows[:, t : t + 1], device=engine.device).long()
            hidden, cache = llama.forward_chunk(engine.params, engine.cfg, engine.duo, cache, tok, 1,
                                                full_bucket=bucket, mesh=engine.mesh)
            out.append(llama.logits_at(engine.params, hidden, 0, mesh=engine.mesh, cfg=engine.cfg).float())
    return torch.stack([engine._gather(x) for x in out]).cpu().numpy()


def generate_job(mesh: Mesh, params: Dict, cfg: ModelConfig, duo: DuoConfig, prompt, max_new_tokens: int,
                 sampling=None, stop_token_ids=None, force=None, **engine_kw) -> dict:
    """``DuoEngine.generate`` of the whole batch ``prompt`` (with
    ``sampling``, an ``ops.sampling.SamplingParams``, or greedy; and
    ``stop_token_ids``) on the rank's slices of full ``params``: the tokens,
    the logits before each of them (``stream_logits``; [0] is the prefill's
    last token's), or before each token of ``force`` [B, n] when given (another
    run's stream, teacher-forced), and each collective's calls in one greedy
    decode step after the generation (``ops/launches.py``'s counters)."""
    from ..engine import DuoEngine
    from ..ops import launches

    engine = DuoEngine(shard_params(mesh, cfg, duo, params), cfg, duo, batch_size=prompt.shape[0],
                       device=mesh.device, mesh=mesh, **engine_kw)
    tokens, cache = engine.generate(prompt, max_new_tokens, sampling=sampling, stop_token_ids=stop_token_ids)
    names = [n for n in launches.counters() if n.startswith(launches.COLLECTIVE)]
    before = dict(zip(launches.counters(), launches.snapshot()))
    engine.decode_step(cache, torch.as_tensor(tokens[engine.shards.batch_start:][: engine.shards.batch, -1]),
                       prompt.shape[1] + max_new_tokens)
    after = dict(zip(launches.counters(), launches.snapshot()))
    step = {n.removeprefix(launches.COLLECTIVE): after[n] - before[n] for n in names}
    logits = stream_logits(engine, prompt, tokens if force is None else np.asarray(force))
    return {"tokens": tokens, "logits": logits, "collectives_per_step": step}


def serve_job(mesh: Mesh, params: Dict, cfg: ModelConfig, duo: DuoConfig, prompts, max_new_tokens: int,
              sampling: Optional[dict] = None, **serve_kw) -> Dict[int, List[int]]:
    """A ``ServingEngine`` run of ``prompts`` (request i is prompt i, sampled
    with ``sampling[i]`` where given) on the rank's slices of full
    ``params``; the streams by request."""
    from ..serving import Request, ServingEngine

    engine = ServingEngine(shard_params(mesh, cfg, duo, params), cfg, duo, device=mesh.device, mesh=mesh,
                           **serve_kw)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt_ids=p, max_new_tokens=max_new_tokens,
                              sampling=(sampling or {}).get(i)))
    return {r.rid: list(r.generated) for r in engine.run()}


def decode_logits_job(mesh: Mesh, params: Dict, cfg: ModelConfig, duo: DuoConfig, tokens, length: int,
                      kv_quant: str = "none", dtype=torch.float32):
    """One decode step of ``tokens`` [B] on a new rank-local cache whose
    length is set to ``length`` (its slots hold zeros, as JAX's sharded
    decode tests set them up); the whole logits [B, vocab]."""
    from ..cache import init_cache, init_cache_q4
    from ..models import llama

    B = tokens.shape[0]
    shards = cache_shardings(mesh, cfg, duo, B)
    init = init_cache_q4 if kv_quant == "int4" else init_cache
    cache = init(cfg, duo, shards.batch, dtype, mesh.device, heads=shards.heads)
    cache.length.fill_(length)
    local = shard_params(mesh, cfg, duo, params)
    rows = torch.as_tensor(tokens, device=mesh.device)[shards.batch_start : shards.batch_start + shards.batch]
    with torch.no_grad():
        hidden, cache = llama.forward_chunk(local, cfg, duo, cache, rows[:, None], 1, mesh=mesh)
        logits = gather_rows(mesh, llama.logits_at(local, hidden, 0, mesh=mesh, cfg=cfg), B)
    if int(cache.length) != length + 1:
        raise AssertionError(f"cache length {int(cache.length)} after a step from {length}")
    return logits.float().cpu().numpy()
