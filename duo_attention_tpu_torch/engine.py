"""Inference engine: chunked prefill, then greedy decode over the split cache.

Counterpart of duo_attention_tpu/engine.py's ``DuoEngine`` for the bf16 cache
and, with ``kv_quant="int4"``, the INT4 full-head cache of the W8A8KV4
serving format (the weights' format is whatever the params hold). Prefill is
a host loop over fixed-size chunks (the tail chunk padded; the masks hide the
padding). Decode runs in bursts: tokens stay on the device within a burst and
come to the host once per burst, where the stop-token early exit is decided.
The power-of-two ``bucket`` bounds the full-head keys the attention reads, as
on the TPU, and is fixed for a whole ``decode_tokens`` call.

On the card a decode step is captured once into a CUDA graph and replayed
once per token, the counterpart of the JAX engine's device-side ``lax.scan``
over a burst: the host issues two launches a step (the token's copy into the
burst's output and the replay), not the step's ~1,800 (bf16) or ~3,650
(W8A8KV4). There is one graph per (format, B, bucket), captured on the cache
it decodes after an eager warm-up step that builds and loads every kernel;
a new cache is captured anew. On the CPU the step runs eagerly, as
``models.llama.forward_chunk``, which also stays the eager step on the card.

Not ported yet: sampling (greedy only), meshes.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .cache import DuoCache, DuoCacheQ4, init_cache, init_cache_q4
from .config import DuoConfig, ModelConfig
from .models import llama
from .ops import launches
from .utils import resolve_device


def _next_bucket(n: int, lo: int = 512) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DuoEngine:
    """Stateful-cache inference engine on one device (the card by default)."""

    def __init__(self, params, cfg: ModelConfig, duo: DuoConfig, batch_size: int = 1,
                 dtype=torch.bfloat16, device="cuda", decode_burst: int = 64,
                 kv_quant: str = "none"):
        if len(duo.num_full_kv_heads) != cfg.num_layers:
            raise ValueError(f"pattern has {len(duo.num_full_kv_heads)} layers, model has "
                             f"{cfg.num_layers} — wrong attn_patterns dir for this model?")
        if not all(0 <= n <= cfg.num_kv_heads for n in duo.num_full_kv_heads):
            raise ValueError(f"num_full_kv_heads {duo.num_full_kv_heads} outside "
                             f"[0, {cfg.num_kv_heads}]")
        if kv_quant not in ("none", "int4"):
            raise ValueError(f"kv_quant must be 'none' or 'int4', got {kv_quant!r}")
        self.kv_quant = kv_quant
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
        self._graphs = {}  # (kv_quant, B, bucket) -> _DecodeGraph, on the card
        self._capture_stream = None

    def new_cache(self) -> Union[DuoCache, DuoCacheQ4]:
        init = init_cache_q4 if self.kv_quant == "int4" else init_cache
        return init(self.cfg, self.duo, self.batch_size, self.dtype, self.device)

    def bucket_for(self, length: int) -> int:
        return min(_next_bucket(length), self.duo.max_cache_size)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def prefill(self, input_ids: np.ndarray, cache: Optional[DuoCache] = None,
                start: int = 0) -> Tuple[DuoCache, torch.Tensor]:
        """Chunked prefill of host ids [B, S]. ``start`` is the host-known
        length already in ``cache``. Returns (cache, last-token logits
        [B, vocab] float32)."""
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
            hidden, cache = llama.forward_chunk(
                self.params, self.cfg, self.duo, cache, self._ids(chunk), n_valid,
                full_bucket=self.bucket_for(pos + C),
            )
            logits = llama.logits_at(self.params, hidden, n_valid - 1)
            pos += n_valid
        return cache, logits

    def generate(self, input_ids: np.ndarray, max_new_tokens: int,
                 cache: Optional[DuoCache] = None, stop_token_ids: Optional[list] = None,
                 sampling=None) -> Tuple[np.ndarray, DuoCache]:
        """Chunked prefill, then greedy decode.

        sampling: None, or an object whose ``is_greedy`` is true; anything
        else raises NotImplementedError (sampling is not ported yet).
        Returns (generated ids [B, max_new_tokens] int32 host array, cache).
        """
        if sampling is not None and not getattr(sampling, "is_greedy", False):
            raise NotImplementedError("only greedy decoding is ported so far")
        input_ids = np.asarray(input_ids)
        if cache is None:
            total = input_ids.shape[1] + max_new_tokens
            if total > self.duo.max_cache_size:
                raise ValueError(f"prompt+generation = {total} tokens exceeds max_cache_size "
                                 f"= {self.duo.max_cache_size}")
        cache, logits = self.prefill(input_ids, cache)
        first_token = torch.argmax(logits, dim=-1)
        tokens, cache = self.decode_tokens(cache, first_token, max_new_tokens,
                                           length=input_ids.shape[1], stop_token_ids=stop_token_ids)
        if stop_token_ids:
            tokens = _truncate_at_stop(tokens, stop_token_ids)
        return tokens, cache

    def decode_tokens(self, cache: DuoCache, first_token: torch.Tensor, max_new_tokens: int,
                      length: int, stop_token_ids: Optional[list] = None
                      ) -> Tuple[np.ndarray, DuoCache]:
        """Decode ``max_new_tokens`` steps in bursts (``_burst_plan``).

        ``length`` is the host-known token count in the cache; first_token
        [B] is fed at that position. With ``stop_token_ids``, decoding stops
        after the first burst in which every row has emitted a stop token and
        the output is padded with the first stop id. Returns (tokens
        [B, max_new_tokens] host array, cache)."""
        plan = _burst_plan(self.decode_burst, max_new_tokens)
        bucket = self.bucket_for(length + sum(plan))
        out = []
        token = first_token.to(self.device)
        for steps in plan:
            tokens, cache, token = self._decode_burst(cache, token, steps, bucket)
            out.append(tokens)
            if stop_token_ids:
                acc = np.concatenate(out, axis=1)
                if all(np.isin(row, stop_token_ids).any() for row in acc):
                    break
        tokens = np.concatenate(out, axis=1)
        if tokens.shape[1] < max_new_tokens:  # early stop: pad with the stop id
            pad = np.full((tokens.shape[0], max_new_tokens - tokens.shape[1]),
                          stop_token_ids[0], tokens.dtype)
            tokens = np.concatenate([tokens, pad], axis=1)
        return tokens[:, :max_new_tokens], cache

    def decode_step(self, cache: DuoCache, token: torch.Tensor, length: int):
        """One decode step; ``length`` is the host-known count before it.
        Returns (the predicted next token [B], cache)."""
        _, cache, nxt = self._decode_burst(cache, token.to(self.device), 1, self.bucket_for(length + 1))
        return nxt, cache

    def _step(self, cache, token: torch.Tensor, bucket: int) -> torch.Tensor:
        """One greedy decode step fed ``token`` [B]; returns the next token [B]."""
        hidden, _ = llama.forward_chunk(self.params, self.cfg, self.duo, cache, token[:, None], 1,
                                        full_bucket=bucket)
        return torch.argmax(llama.logits_at(self.params, hidden, 0), dim=-1)

    @torch.no_grad()
    def _decode_burst(self, cache: DuoCache, token: torch.Tensor, steps: int, bucket: int):
        """``steps`` greedy steps. Emits the token fed at each step, so the
        output starts with ``token``; also returns the token after the last
        one emitted, so bursts chain. Decoding past max_cache_size clamps the
        full-cache writes, so the results are garbage: the whole output is
        then poisoned with -1."""
        if self.device.type == "cuda":
            tokens, token = self._graph_burst(cache, token, steps, bucket)
        else:
            emitted = []
            for _ in range(steps):
                emitted.append(token)
                token = self._step(cache, token, bucket)
            tokens = torch.stack(emitted, dim=1) if emitted else token.new_empty((token.shape[0], 0))
        overrun = (cache.length > self.duo.max_cache_size).any()
        tokens = torch.where(overrun, torch.full_like(tokens, -1), tokens)
        return tokens.cpu().numpy().astype(np.int32), cache, token

    def _graph_burst(self, cache, token: torch.Tensor, steps: int, bucket: int):
        """The burst on the card: per step, one copy puts the token fed into
        the output, then the captured step is replayed, which writes the next
        token into the graph's token buffer. Without a graph for this cache,
        the first step runs eagerly and the step is captured after it."""
        out = torch.empty((token.shape[0], steps), dtype=torch.long, device=self.device)
        if steps == 0:
            return out, token
        key = (self.kv_quant, token.shape[0], bucket)
        graph = self._graphs.get(key)
        first = 0
        if graph is None or graph.cache() is not cache:  # none yet, or captured on another cache
            self._graphs.pop(key, None)  # frees the old graph's memory pool
            tok = token.to(torch.long).clone()
            out[:, 0].copy_(tok)
            graph = self._graphs[key] = self._capture(cache, tok, bucket)
            first = 1
        else:
            graph.tok.copy_(token)
        for i in range(first, steps):
            out[:, i].copy_(graph.tok)
            graph.replay()
        return out, graph.tok.clone()

    def _capture(self, cache, tok: torch.Tensor, bucket: int) -> "_DecodeGraph":
        """An eager warm-up step (it builds and loads every kernel and makes
        the decode scratch outside the capture; it is the burst's first step),
        then the step captured on the same side stream. A capture that fails
        raises."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            tok.copy_(self._step(cache, tok, bucket))
            graph = torch.cuda.CUDAGraph()
            before = launches.snapshot()
            # capture_begin/end rather than torch.cuda.graph(), whose gc.collect()
            # and empty_cache() cost ~0.3 s a capture after a 16k-token prefill
            graph.capture_begin()
            try:
                tok.copy_(self._step(cache, tok, bucket))
            finally:
                graph.capture_end()
            delta = [after - b for after, b in zip(launches.snapshot(), before)]
            launches.add([-d for d in delta])  # the capture launched nothing
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return _DecodeGraph(graph, tok, weakref.ref(cache), delta)


class _DecodeGraph:
    """A captured decode step: ``tok`` [B] is the token it is fed, which the
    step overwrites with its argmax; ``cache`` a weak reference to the cache
    whose buffers it was captured on; ``delta`` each launch counter's
    movement in one step (``ops.launches``), added on every replay."""

    def __init__(self, graph: torch.cuda.CUDAGraph, tok: torch.Tensor, cache: weakref.ref, delta: list):
        self.graph, self.tok, self.cache, self.delta = graph, tok, cache, delta

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.delta)


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


def _truncate_at_stop(tokens: np.ndarray, stop_ids) -> np.ndarray:
    out = tokens.copy()
    for b in range(out.shape[0]):
        for t in range(out.shape[1]):
            if out[b, t] in stop_ids:
                out[b, t + 1 :] = stop_ids[0]
                break
    return out
