"""Inference engine: chunked prefill, then greedy or sampled decode over the split cache.

Counterpart of duo_attention_tpu/engine.py's ``DuoEngine`` for the bf16 cache
and, with ``kv_quant="int4"``, the INT4 full-head cache of the W8A8KV4
serving format (the weights' format is whatever the params hold). Prefill is
a host loop over fixed-size chunks (the tail chunk padded; the masks hide the
padding). Decode runs in bursts: tokens stay on the device within a burst and
come to the host once per burst, where the stop-token early exit is decided.
The power-of-two ``bucket`` bounds the full-head keys the attention reads, as
on the TPU, and is fixed for a whole ``decode_tokens`` call.
``single_bucket=True`` pins every step to ``max_cache_size``, as the JAX
engine's does (one captured graph per B and sampled instead of one
per bucket): the prefill kernels stop at each query tile's causal end, and
the decode kernels' splits past the live length exit at once, so the
runtime still follows the true length (``PERF.md`` says how closely).

On the card a decode step is captured once into a CUDA graph and replayed
once per token, the counterpart of the JAX engine's device-side ``lax.scan``
over a burst: the host issues two launches a step (the token's copy into the
burst's output and the replay), not the step's ~1,500-1,800 kernels. There is
one graph per (B, bucket, sampled), captured on the cache it decodes
after an eager warm-up step that builds and loads every kernel; a new cache
is captured anew. ``capture_step`` captures any step closure that reads and
writes only tensors (``serving.ServingEngine`` captures its pool step with
it); a capture that fails raises, and nothing falls back to eager decode. On
the CPU the step runs eagerly, as ``models.llama.forward_chunk``.

Sampling (``ops/sampling.py``) draws from JAX's threefry stream with the key
sequence of the JAX engine: ``key, sub = split(PRNGKey(seed))`` for the first
token, one split per burst on the host side, and one per step inside the
step. The sampled step reads its key, temperature, top-p and top-k from the
graph's buffers and writes the advanced key back in place, so each replay
draws anew.

Tensor parallelism (``mesh=``, ``parallel/mesh.py``): every rank of the mesh
builds the engine on its own slices of the params (``shard_params``) and
calls it with the same arguments; the cache holds the rank's KV heads and,
when the batch divides the data axis, its data group's rows. The whole
logits reach every tensor rank, and each step's token is broadcast from
tensor-rank 0 all the same, so the host loops never drift apart;
``generate`` returns the whole batch on every rank. The decode step is
captured only where the mesh's collectives can be (NCCL, not gloo:
``Mesh.capturable``); under gloo it runs eagerly.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import tracing
from .cache import DuoCache, DuoCacheQ4, cache_constructor
from .config import DuoConfig, ModelConfig
from .models import llama
from .ops import launches
from .ops.sampling import prng_key, sample_tokens, split
from .parallel import mesh as pmesh
from .utils import resolve_device


def bucket_for_length(length: int, max_cache_size: int) -> int:
    """The full-head keys a step may read for ``length`` tokens: the
    smallest power of two >= max(length, 512), capped at ``max_cache_size``.
    Every engine's bucket comes from here."""
    b = 512
    while b < length:
        b *= 2
    return min(b, max_cache_size)


class StepGraph:
    """A captured step: ``graph`` replays its launches on the tensors it was
    captured on, ``bufs`` the static tensors through which the caller feeds
    and reads it, ``owner`` a weak reference to the cache it decodes,
    ``delta`` each launch counter's movement in one step (``ops.launches``),
    added on every replay, and ``seconds`` the capture's host time (the
    warm-up step excluded)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, bufs: tuple, owner, delta: list, seconds: float):
        self.graph, self.bufs, self.owner, self.delta, self.seconds = graph, bufs, owner, delta, seconds

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.delta)


_capture_streams = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` runs on, one per device
    and shared by all engines: cuBLAS keeps a workspace for each stream it
    has run on for the life of the process, so one stream makes one."""
    dev = torch.device(device)
    dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream(dev)
    return _capture_streams[dev]


def capture_step(step: Callable[[], None], stream: torch.cuda.Stream, owner, bufs: tuple) -> StepGraph:
    """Run ``step`` once eagerly on ``stream`` (it builds and loads every
    kernel and makes the decode scratch outside the capture; it is a real
    step, whose results the caller keeps), then capture it on the same
    stream. ``step`` must read and write only device tensors that outlive the
    graph (``bufs`` and ``owner``'s cache). A capture that fails raises."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        step()
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        t0 = time.perf_counter()
        # capture_begin/end rather than torch.cuda.graph(), whose gc.collect()
        # and empty_cache() cost ~0.3 s a capture after a 16k-token prefill
        graph.capture_begin()
        try:
            step()
        finally:
            graph.capture_end()
        seconds = time.perf_counter() - t0
        delta = [after - b for after, b in zip(launches.snapshot(), before)]
        launches.add([-d for d in delta])  # the capture launched nothing
    current.wait_stream(stream)
    return StepGraph(graph, bufs, weakref.ref(owner), delta, seconds)


class DuoEngine:
    """Stateful-cache inference engine on one device (the card by default),
    or on one rank of a tensor-parallel mesh (``mesh``)."""

    def __init__(self, params, cfg: ModelConfig, duo: DuoConfig, batch_size: int = 1,
                 dtype=torch.bfloat16, device="cuda", decode_burst: int = 64,
                 kv_quant: str = "none", single_bucket: bool = False, mesh=None):
        if len(duo.num_full_kv_heads) != cfg.num_layers:
            raise ValueError(f"pattern has {len(duo.num_full_kv_heads)} layers, model has "
                             f"{cfg.num_layers} — wrong attn_patterns dir for this model?")
        if not all(0 <= n <= cfg.num_kv_heads for n in duo.num_full_kv_heads):
            raise ValueError(f"num_full_kv_heads {duo.num_full_kv_heads} outside "
                             f"[0, {cfg.num_kv_heads}]")
        self._init_cache = cache_constructor(kv_quant)  # the full-head format's constructor
        self.device = resolve_device(device)
        params_device = params["final_norm"].device  # W8A8 params may hold no "embed"
        if params_device.type != self.device.type:
            raise ValueError(f"params are on {params_device}, the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.duo = duo
        self.batch_size = batch_size
        self.dtype = dtype
        # decode steps per host round trip (the stop-token check runs between bursts)
        self.decode_burst = max(int(decode_burst), 0)
        self.single_bucket = single_bucket
        self._graphs = {}  # (B, bucket, sampled) -> StepGraph, on the card
        self.mesh = mesh
        # the rank's cache layout: its KV heads and its slice of the batch
        self.shards = None
        if mesh is not None:
            pmesh.check_sharded(mesh, cfg, duo, params)
            self.shards = pmesh.cache_shardings(mesh, cfg, duo, batch_size)
        # decode from captured graphs: on the card, where the collectives (if any) can be captured
        self.captures = self.device.type == "cuda" and (mesh is None or mesh.capturable)

    def new_cache(self) -> Union[DuoCache, DuoCacheQ4]:
        if self.mesh is None:
            return self._init_cache(self.cfg, self.duo, self.batch_size, self.dtype, self.device)
        return self._init_cache(self.cfg, self.duo, self.shards.batch, self.dtype, self.device,
                                heads=self.shards.heads)

    def local_rows(self, ids: np.ndarray) -> np.ndarray:
        """The rows of a [batch_size, ...] host batch this rank's data group
        runs (all of them without a mesh, or when the batch does not split)."""
        if self.mesh is None:
            return ids
        return ids[self.shards.batch_start : self.shards.batch_start + self.shards.batch]

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole batch from the data groups' rows (a no-op unless the
        batch is split over the data axis)."""
        return local if self.mesh is None else pmesh.gather_rows(self.mesh, local, self.batch_size)

    def _agree(self, token: torch.Tensor) -> torch.Tensor:
        """The tensor group's token: tensor-rank 0's, broadcast (every rank
        computed the same one from the same logits)."""
        return token if self.mesh is None else pmesh.broadcast(self.mesh, token)

    def bucket_for(self, length: int) -> int:
        if self.single_bucket:
            return self.duo.max_cache_size
        return bucket_for_length(length, self.duo.max_cache_size)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def prefill(self, input_ids: np.ndarray, cache: Optional[DuoCache] = None,
                start: int = 0) -> Tuple[DuoCache, torch.Tensor]:
        """Chunked prefill of host ids [B, S] (under a mesh: the rank's rows,
        ``local_rows``). ``start`` is the host-known length already in
        ``cache``. Returns (cache, last-token logits [B, vocab] float32).
        Each chunk is an ``engine.prefill_chunk`` span (``tracing``)."""
        if cache is None:
            cache = self.new_cache()
        input_ids = np.asarray(input_ids)
        B, S = input_ids.shape
        C = self.duo.prefill_chunk_size
        logits = None
        pos = start
        for off in range(0, S, C):
            chunk = input_ids[:, off : off + C]
            n_valid = chunk.shape[1]
            if n_valid < C:  # pad the tail chunk; the masks hide the padding
                chunk = np.pad(chunk, ((0, 0), (0, C - n_valid)))
            with tracing.span("engine.prefill_chunk", device=self.device, tokens=n_valid):
                hidden, cache = llama.forward_chunk(
                    self.params, self.cfg, self.duo, cache, self._ids(chunk), n_valid,
                    full_bucket=self.bucket_for(pos + C), mesh=self.mesh,
                )
                logits = llama.logits_at(self.params, hidden, n_valid - 1, mesh=self.mesh, cfg=self.cfg)
            pos += n_valid
        return cache, logits

    @torch.no_grad()
    def generate(self, input_ids: np.ndarray, max_new_tokens: int,
                 cache: Optional[DuoCache] = None, stop_token_ids: Optional[list] = None,
                 sampling=None) -> Tuple[np.ndarray, DuoCache]:
        """Chunked prefill, then decode.

        sampling: None or an ``ops.sampling.SamplingParams``; None or
        temperature 0 decodes greedily, anything else samples with
        temperature / top-p / top-k from ``PRNGKey(sampling.seed)``, as the
        JAX engine does. Returns (generated ids [B, max_new_tokens] int32
        host array, cache). Under a mesh every rank passes the whole batch and
        gets the whole batch back; the cache is the rank's.
        """
        input_ids = np.asarray(input_ids)
        if cache is None:
            total = input_ids.shape[1] + max_new_tokens
            if total > self.duo.max_cache_size:
                raise ValueError(f"prompt+generation = {total} tokens exceeds max_cache_size "
                                 f"= {self.duo.max_cache_size}")
        cache, logits = self.prefill(self.local_rows(input_ids), cache)
        sample_args = None
        if sampling is not None and not sampling.is_greedy:
            B = input_ids.shape[0]
            vec = lambda v, dt: torch.full((B,), v, dtype=dt, device=self.device)  # noqa: E731
            temp, top_p = vec(sampling.temperature, torch.float32), vec(sampling.top_p, torch.float32)
            top_k = vec(sampling.top_k, torch.int32)
            key, sub = split(prng_key(sampling.seed, self.device))
            first_token = self._sample(logits, sub, temp, top_p, top_k)
            sample_args = (key, temp, top_p, top_k)
        else:
            first_token = self._agree(torch.argmax(logits, dim=-1))
        tokens, cache = self.decode_tokens(cache, first_token, max_new_tokens, length=input_ids.shape[1],
                                           sample_args=sample_args, stop_token_ids=stop_token_ids)
        if self.mesh is not None:
            tokens = self._gather(torch.as_tensor(tokens, device=self.device).long()).cpu().numpy().astype(np.int32)
        if stop_token_ids:
            tokens = truncate_at_stop(tokens, stop_token_ids)
        return tokens, cache

    def _sample(self, logits: torch.Tensor, key, temp, top_p, top_k) -> torch.Tensor:
        """Draw the rank's rows as the whole batch draws them from ``key``:
        under a batch split over the data axis the logits are gathered
        first, and the rank keeps its rows of the draw. temp/top_p/top_k are
        the whole batch's."""
        full = self._gather(logits.float())
        nxt = sample_tokens(full, key, temp, top_p, top_k)
        if self.mesh is not None:
            nxt = self._agree(self.local_rows(nxt))
        return nxt

    def decode_tokens(self, cache: DuoCache, first_token: torch.Tensor, max_new_tokens: int,
                      length: int, sample_args=None, stop_token_ids: Optional[list] = None
                      ) -> Tuple[np.ndarray, DuoCache]:
        """Decode ``max_new_tokens`` steps in bursts (``_burst_plan``).

        ``length`` is the host-known token count in the cache; first_token
        [B] is fed at that position. ``sample_args``: None (greedy) or (key
        [2], temperature [B], top_p [B], top_k [B]) device tensors; each
        burst splits ``key`` and hands the subkey to its steps. With
        ``stop_token_ids``, decoding stops after the first burst in which
        every row (under a mesh, of every data group) has emitted a stop
        token and the output is padded with the first stop id. Returns
        (tokens [B, max_new_tokens] host array, cache)."""
        plan = _burst_plan(self.decode_burst, max_new_tokens)
        bucket = self.bucket_for(length + sum(plan))
        out = []
        token = first_token.to(self.device)
        key = None if sample_args is None else sample_args[0]
        for steps in plan:
            samp = None
            if sample_args is not None:
                key, sub = split(key)
                samp = (sub.clone(), *sample_args[1:])
            tokens, cache, token = self._decode_burst(cache, token, steps, bucket, samp)
            out.append(tokens)
            if stop_token_ids:
                acc = np.concatenate(out, axis=1)
                done = all(np.isin(row, stop_token_ids).any() for row in acc)
                if self.mesh is not None:  # the rows are the data group's: every group stops together
                    done = pmesh.every_group(self.mesh, done)
                if done:
                    break
        tokens = np.concatenate(out, axis=1)
        if tokens.shape[1] < max_new_tokens:  # early stop: pad with the stop id
            pad = np.full((tokens.shape[0], max_new_tokens - tokens.shape[1]),
                          stop_token_ids[0], tokens.dtype)
            tokens = np.concatenate([tokens, pad], axis=1)
        return tokens[:, :max_new_tokens], cache

    def decode_step(self, cache: DuoCache, token: torch.Tensor, length: int):
        """One greedy decode step; ``length`` is the host-known count before
        it. Returns (the predicted next token [B], cache)."""
        _, cache, nxt = self._decode_burst(cache, token.to(self.device), 1, self.bucket_for(length + 1))
        return nxt, cache

    def _next_token(self, cache, token: torch.Tensor, bucket: int, samp=None) -> torch.Tensor:
        """One decode step fed ``token`` [B]; returns the next token [B]: the
        argmax, or with ``samp`` = (key [2], temperature, top_p, top_k) a draw
        on a split of ``key``, which advances in place."""
        hidden, _ = llama.forward_chunk(self.params, self.cfg, self.duo, cache, token[:, None], 1,
                                        full_bucket=bucket, mesh=self.mesh)
        logits = llama.logits_at(self.params, hidden, 0, mesh=self.mesh, cfg=self.cfg)
        if samp is None:
            return self._agree(torch.argmax(logits, dim=-1))
        key, temp, top_p, top_k = samp
        both = split(key)
        nxt = self._sample(logits, both[1], temp, top_p, top_k)
        key.copy_(both[0])
        return nxt

    @torch.no_grad()
    def _decode_burst(self, cache: DuoCache, token: torch.Tensor, steps: int, bucket: int, samp=None):
        """``steps`` decode steps. Emits the token fed at each step, so the
        output starts with ``token``; also returns the token after the last
        one emitted, so bursts chain. ``samp``: None (greedy) or (key [2],
        temperature, top_p, top_k), the burst's own key. Decoding past max_cache_size clamps the full-cache writes, so the
        results are garbage: the whole output is then poisoned with -1."""
        if self.captures:
            tokens, token = self._graph_burst(cache, token, steps, bucket, samp)
        else:
            emitted = []
            for _ in range(steps):
                emitted.append(token)
                token = self._next_token(cache, token, bucket, samp)
            tokens = torch.stack(emitted, dim=1) if emitted else token.new_empty((token.shape[0], 0))
        overrun = (cache.length > self.duo.max_cache_size).any()
        tokens = torch.where(overrun, torch.full_like(tokens, -1), tokens)
        return tokens.cpu().numpy().astype(np.int32), cache, token

    def _graph_burst(self, cache, token: torch.Tensor, steps: int, bucket: int, samp=None):
        """The burst on the card: per step, one copy puts the token fed into
        the output, then the captured step is replayed, which writes the next
        token into the graph's token buffer (and, sampled, advances the
        graph's key). Without a graph for this cache, the first step runs
        eagerly and the step is captured after it."""
        out = torch.empty((token.shape[0], steps), dtype=torch.long, device=self.device)
        if steps == 0:
            return out, token
        key = (token.shape[0], bucket, samp is not None)
        inputs = (token.to(torch.long), *(samp or ()))
        graph = self._graphs.get(key)
        first = 0
        if graph is None or graph.owner() is not cache:  # none yet, or captured on another cache
            self._graphs.pop(key, None)  # frees the old graph's memory pool
            bufs = tuple(t.clone() for t in inputs)
            out[:, 0].copy_(bufs[0])
            tok, samp_bufs = bufs[0], (bufs[1:] or None)
            graph = self._graphs[key] = capture_step(
                lambda: tok.copy_(self._next_token(cache, tok, bucket, samp_bufs)),
                capture_stream(self.device), cache, bufs)
            first = 1
        else:
            for buf, t in zip(graph.bufs, inputs):
                buf.copy_(t)
        for i in range(first, steps):
            out[:, i].copy_(graph.bufs[0])
            graph.replay()
        return out, graph.bufs[0].clone()


def _burst_plan(burst: int, n: int) -> list:
    """Decompose ``n`` decode steps into full bursts plus a power-of-two
    decomposition of the remainder (exact total; at most 1 + log2(burst)
    distinct lengths)."""
    if burst <= 0 or n <= 0:
        return [max(n, 0)]
    plan = [burst] * (n // burst)
    rem = n % burst
    while rem:
        p = 1 << (rem.bit_length() - 1)
        plan.append(p)
        rem -= p
    return plan


def truncate_at_stop(tokens: np.ndarray, stop_ids) -> np.ndarray:
    """Each row of ``tokens`` [B, n] cut after its first stop id, the rest
    filled with the first stop id."""
    out = tokens.copy()
    for b in range(out.shape[0]):
        for t in range(out.shape[1]):
            if out[b, t] in stop_ids:
                out[b, t + 1 :] = stop_ids[0]
                break
    return out
