"""Pipeline-parallel (layer-stage) inference engine.

Counterpart of duo_attention_tpu/parallel/pipeline.py, itself the
counterpart of the reference's ``--enable_pp`` (duo_attn/utils.py:228-283):
accelerate's balanced device map puts contiguous layer groups on successive
GPUs (the embedding on the first, the final norm and the head on the last)
and runs them one after the other. It is a memory-capacity feature (a model
whose weights and KV exceed one card), not a throughput one.

Here one process drives every stage: stage s holds its params and its cache
on ``devices[s]`` and runs ``models.llama.forward_chunk`` on them, fed ids
(stage 0) or the previous stage's hidden states [B, S, E], moved to its
device. Each stage's cache is built from the stage's config and its slice of
``num_full_kv_heads``, so a per-layer head split that crosses a stage bound
needs no padding. Decode is a host loop of per-stage eager steps, as JAX's
is: the next token needs the last stage's logits. A list that names one card
more than once runs every stage there, in turn (the one way to run stages
on a single card): its times are not a pipeline speed figure.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cache import cache_constructor, kv_memory_bytes
from ..config import DuoConfig, ModelConfig
from ..engine import bucket_for_length, truncate_at_stop
from ..models import llama
from ..utils import resolve_device


def balanced_stage_bounds(num_layers: int, num_stages: int) -> List[int]:
    """Contiguous layer-group bounds, larger groups first (accelerate's
    balanced split: one more layer in each of the first ``num_layers %
    num_stages`` stages). Stage s owns layers [b[s], b[s + 1])."""
    if not 1 <= num_stages <= num_layers:
        raise ValueError(f"{num_stages} stages for {num_layers} layers")
    base, extra = divmod(num_layers, num_stages)
    bounds = [0]
    for s in range(num_stages):
        bounds.append(bounds[-1] + base + (1 if s < extra else 0))
    return bounds


_EMBED_KEYS = ("embed", "embed_q8", "embed_scale")
_HEAD_KEYS = ("final_norm", "lm_head", "lm_head_q8", "lm_head_scale")


def split_stage_params(params, num_stages: int):
    """(per-stage param dicts, bounds). Stage 0 holds the embedding, the last
    stage the final norm and the head (the reference's placement,
    utils.py:254-266); a tied embedding (no head of its own) is duplicated
    onto the last stage, whose ``logits_at`` reads it. A last stage fed
    hidden states never looks its embedding up."""
    L = len(params["layers"])
    bounds = balanced_stage_bounds(L, num_stages)
    stages = []
    for s in range(num_stages):
        sp = {"layers": list(params["layers"][bounds[s] : bounds[s + 1]])}
        keys = list(_EMBED_KEYS) if s == 0 else []
        if s == num_stages - 1:
            keys += _HEAD_KEYS
            if "lm_head" not in params and "lm_head_q8" not in params:
                keys += _EMBED_KEYS  # the tied head
        sp.update({k: params[k] for k in keys if k in params})
        stages.append(sp)
    return stages, bounds


def default_devices() -> List[torch.device]:
    """Every card present, one stage each; raises with no GPU."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def stage_devices(n: int, device="cuda") -> List[torch.device]:
    """``n`` stage devices for ``--pp n``: the cards in turn (stage s on card
    s mod the cards present, so one card takes every stage when it is the
    only one), or the CPU ``n`` times."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", s % torch.cuda.device_count()) for s in range(n)]
    return [dev] * n


class PipelinedEngine:
    """Sequential stage-parallel inference over explicit devices.

    The surface of JAX's: ``new_caches``, ``prefill``, ``generate``,
    ``bucket_for``, ``kv_memory_bytes``. ``devices`` is a list of
    ``torch.device`` (or names), one a stage; the default is every card
    present. params may lie anywhere: each stage's are copied to its device."""

    def __init__(self, params, cfg: ModelConfig, duo: DuoConfig, devices: Optional[Sequence] = None,
                 batch_size: int = 1, dtype=torch.bfloat16, kv_quant: str = "none"):
        self.devices = [resolve_device(d) for d in (devices if devices is not None else default_devices())]
        self._init_cache = cache_constructor(kv_quant)  # the full-head format's constructor
        if len(duo.num_full_kv_heads) != cfg.num_layers:
            raise ValueError(f"pattern has {len(duo.num_full_kv_heads)} layers, model has {cfg.num_layers}")
        n = len(self.devices)
        stage_params, bounds = split_stage_params(params, n)
        self.stage_params = [_to(sp, d) for sp, d in zip(stage_params, self.devices)]
        self.bounds = bounds
        self.cfg = cfg
        self.duo = duo
        self.batch_size = batch_size
        self.dtype = dtype
        # per-stage configs: the stage's layer count and its slice of the head split
        self.stage_cfgs = [dataclasses.replace(cfg, num_layers=bounds[s + 1] - bounds[s]) for s in range(n)]
        self.stage_duos = [dataclasses.replace(duo, num_full_kv_heads=tuple(duo.num_full_kv_heads[bounds[s]:
                                                                                                 bounds[s + 1]]))
                           for s in range(n)]

    @property
    def shares_a_card(self) -> bool:
        """Whether two stages run on one device (their times are then no
        pipeline speed figure)."""
        return len(set(map(str, self.devices))) < len(self.devices)

    def bucket_for(self, length: int) -> int:
        return bucket_for_length(length, self.duo.max_cache_size)

    def new_caches(self):
        """One cache a stage, on the stage's device."""
        return [self._init_cache(c, d_, self.batch_size, self.dtype, dev)
                for c, d_, dev in zip(self.stage_cfgs, self.stage_duos, self.devices)]

    @torch.no_grad()
    def _run_chunk(self, caches, x: torch.Tensor, n_valid: int, bucket: int) -> Tuple[torch.Tensor, list]:
        """Thread one chunk through every stage: x is ids [B, S] or hidden
        states; returns the last stage's hidden states (after the final norm)."""
        for s, dev in enumerate(self.devices):
            x, caches[s] = llama.forward_chunk(self.stage_params[s], self.stage_cfgs[s], self.stage_duos[s],
                                               caches[s], x.to(dev), n_valid, full_bucket=bucket)
        return x, caches

    def _logits(self, hidden: torch.Tensor, index: int) -> torch.Tensor:
        return llama.logits_at(self.stage_params[-1], hidden, index)

    def prefill(self, input_ids: np.ndarray, caches=None, ret_logits: bool = True):
        """Chunked prefill through the pipeline; returns (caches, last-token
        logits [B, vocab] float32 on the last stage's device, or None)."""
        if caches is None:
            caches = self.new_caches()
        input_ids = np.asarray(input_ids)
        B, S = input_ids.shape
        C = self.duo.prefill_chunk_size
        pos, hidden, n_valid = 0, None, C
        for off in range(0, S, C):
            chunk = input_ids[:, off : off + C]
            n_valid = chunk.shape[1]
            if n_valid < C:
                chunk = np.pad(chunk, ((0, 0), (0, C - n_valid)))
            ids = torch.as_tensor(chunk, dtype=torch.long, device=self.devices[0])
            hidden, caches = self._run_chunk(caches, ids, n_valid, self.bucket_for(pos + C))
            pos += n_valid
        return caches, (self._logits(hidden, n_valid - 1) if ret_logits else None)

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, max_new_tokens: int,
                 stop_token_ids: Optional[list] = None) -> Tuple[np.ndarray, list]:
        """Greedy generation: prefill, then one pipelined step a token
        (``decode_tokens``). Returns (tokens [B, max_new_tokens] int32,
        caches)."""
        input_ids = np.asarray(input_ids)
        total = input_ids.shape[1] + max_new_tokens
        if total > self.duo.max_cache_size:
            raise ValueError(f"prompt+generation = {total} exceeds max_cache_size = {self.duo.max_cache_size}")
        caches, logits = self.prefill(input_ids)
        return self.decode_tokens(caches, torch.argmax(logits, dim=-1), max_new_tokens, input_ids.shape[1],
                                  stop_token_ids)

    @torch.no_grad()
    def decode_tokens(self, caches, first_token: torch.Tensor, max_new_tokens: int, length: int,
                      stop_token_ids: Optional[list] = None) -> Tuple[np.ndarray, list]:
        """``max_new_tokens`` greedy steps from ``first_token`` [B] (emitted
        first) with ``length`` tokens in the caches, one host round trip a
        token. Stops once every row has emitted a stop token, pads with the
        first stop id and cuts each row after its first
        (``engine.truncate_at_stop``)."""
        bucket = self.bucket_for(length + max_new_tokens)
        token = first_token.to(self.devices[0])
        out = []
        for _ in range(max_new_tokens):
            out.append(token.cpu().numpy().astype(np.int32))
            hidden, caches = self._run_chunk(caches, token[:, None], 1, bucket)
            token = torch.argmax(self._logits(hidden, 0), dim=-1).to(self.devices[0])
            if stop_token_ids and all(np.isin(row, stop_token_ids).any() for row in np.stack(out, axis=1)):
                break
        tokens = np.stack(out, axis=1)
        if tokens.shape[1] < max_new_tokens:
            pad = np.full((tokens.shape[0], max_new_tokens - tokens.shape[1]), stop_token_ids[0], tokens.dtype)
            tokens = np.concatenate([tokens, pad], axis=1)
        if stop_token_ids:
            tokens = truncate_at_stop(tokens, stop_token_ids)
        return tokens[:, :max_new_tokens], caches

    def kv_memory_bytes(self, caches) -> int:
        return sum(kv_memory_bytes(c) for c in caches)


def _to(params, device: torch.device):
    """A param dict (layers a list of dicts) with every tensor on ``device``."""
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(device) for k, v in layer.items()} for layer in params["layers"]]
    return out
