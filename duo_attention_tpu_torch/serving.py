"""Continuous-batching serving engine (counterpart of duo_attention_tpu/serving.py).

* The pool is one decode-only cache of ``max_batch_size`` rows with
  **per-sequence lengths** (``length`` a [B] int32 tensor); every kernel of
  the decode step reads each row's own length, so one step serves B
  sequences at B context lengths.
* **Admission** prefills a request chunk by chunk on a B=1 ``DuoEngine``,
  then splices the row into the pool **in place** (``_row_cache_to_batch``):
  the captured pool steps keep reading the same tensors. One prefill chunk
  runs per scheduler iteration, between decode bursts (Sarathi-style
  chunked-prefill scheduling, a bounded stall).
* **Completion** frees the slot (stop token or token budget). A freed slot
  keeps its KV and its device length, which may pass the pool's bucket; the
  step's ``n_valid`` (the active mask) tells the bf16 full-head decode to
  read none of its keys, its row's output is discarded, and the next
  admission overwrites it.

On the card the pool step is captured once per (bucket, sampled) into a CUDA
graph (``engine.capture_step``) on the pool cache, which persists:
admissions, slot reuse and later bursts replay the same graph. The tokens,
the active mask, and the per-slot sampling vectors and keys live in static
device buffers that the host refills between bursts. Admission prefill and
pool decode run on one stream: the decode kernels' scratch
(``ops/flash.py::_scratch``) is shared by every caller on a device. On the
CPU the same step runs eagerly.

Spans (``tracing``): each ``step()`` is a ``serve.step`` span around its
admission chunk (``serve.admit``, holding the prefill engine's
``engine.prefill_chunk`` spans) and its decode burst (``serve.decode``,
with the burst's live rows and KV counters, ``_burst_counts``), recorded
while a profiler runs or inside ``tracing.recording()``. The counters come
from host state alone: ``stale`` mirrors each freed slot's device length.

Tensor parallelism (``mesh=``, ``parallel/mesh.py``): every rank builds the
engine on its slices of the params and is submitted the same requests; the
scheduler runs in lockstep on every rank. The pool cache holds the rank's
KV heads and, when the pool divides the data axis, its data group's slots:
a slot's admission is prefilled by its group alone, and the first token and
each burst's tokens are gathered over the data groups (a zero-padded
all_reduce), so every rank's host state, which depends on those tokens
only, stays the same. Within a tensor group each step's tokens are
tensor-rank 0's (``_batched_decode_step`` broadcasts them). The pool step
is captured only where the mesh's collectives can be (NCCL).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import tracing
from .cache import init_cache, init_cache_q4, kv_memory_bytes, ring_slot_positions
from .config import DuoConfig, ModelConfig
from .engine import DuoEngine, _next_bucket, capture_step, capture_stream
from .models import llama
from .ops.sampling import SamplingParams, prng_key, sample_tokens_rowkeys, split
from .parallel import mesh as pmesh
from .utils import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: np.ndarray  # [S]
    max_new_tokens: int
    stop_token_ids: tuple = ()
    # None or temperature == 0 -> greedy; else temperature/top-p/top-k
    # sampling on a per-request key stream (ops/sampling.py)
    sampling: Optional[SamplingParams] = None
    # filled in by the engine:
    generated: Optional[List[int]] = None
    prompt_len: int = 0
    slot: int = -1
    done: bool = False


@torch.no_grad()
def _row_cache_to_batch(batch_cache, row_cache, slot: int):
    """Splice a prefilled B=1 cache into pool row ``slot``, in place: every
    buffer is written with ``copy_`` into the pool's own tensors (a captured
    graph keeps reading them), and so is ``length[slot]``.

    The pool's streaming buffers are decode-only sized (``cache.ring_capacity
    (duo, decode_only=True)``), smaller than the admission's chunk-prefill
    buffers, so the sink is cut to the pool's rows and the ring is re-based:
    pool slot s receives the token at the latest position g = s (mod R_pool),
    read from the admission ring at g % R_admission. Both sides address slots
    by position mod their own R, so the masks keep working. Returns the pool.
    """
    length = row_cache.length
    for name in batch_cache.BUFFERS:
        for bb, rb in zip(getattr(batch_cache, name), getattr(row_cache, name)):
            rb = rb.to(bb.dtype)
            if name in ("k_sink", "v_sink"):
                rb = rb[:, :, : bb.shape[2]]
            elif name in ("k_ring", "v_ring") and rb.shape[2] != bb.shape[2]:
                g = ring_slot_positions(bb.shape[2], length)  # [R_pool]
                src = torch.remainder(torch.clamp_min(g, 0), rb.shape[2])
                rb = rb.index_select(2, src)
            bb[slot : slot + 1].copy_(rb)
    batch_cache.length[slot] = length
    return batch_cache


def _batched_decode_step(params, cfg: ModelConfig, duo: DuoConfig, cache, tokens: torch.Tensor,
                         active: torch.Tensor, samp=None, *, full_bucket: int, mesh=None) -> torch.Tensor:
    """One decode step for every slot; inactive slots do not advance.

    tokens [B] int64; active [B] bool. samp: None for all-greedy, else (keys
    [B, 2], temperature [B], top_p [B], top_k [B]); each row draws on its own
    key, and the advanced keys are written back into ``keys`` in place.
    Returns the next tokens [B] (an inactive row keeps its token). Under a
    mesh the rows are the rank's and the tokens tensor-rank 0's."""
    hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tokens[:, None],
                                        n_valid=active.to(torch.int32), full_bucket=full_bucket, mesh=mesh)
    logits = llama.logits_at(params, hidden, 0, mesh=mesh, cfg=cfg)  # [B, vocab]
    if samp is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        keys, temp, top_p, top_k = samp
        nxt, keys_next = sample_tokens_rowkeys(logits.float(), keys, temp, top_p, top_k)
        keys.copy_(keys_next)
    if mesh is not None:
        pmesh.broadcast(mesh, nxt)
    return torch.where(active, nxt, tokens)


class ServingEngine:
    """Continuous-batching engine over a fixed pool of batch slots."""

    def __init__(self, params, cfg: ModelConfig, duo: DuoConfig, max_batch_size: int = 4,
                 dtype=torch.bfloat16, kv_quant: str = "none", decode_burst: int = 1,
                 device="cuda", timing: bool = False, mesh=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.duo = duo
        self.B = max_batch_size
        self.kv_quant = kv_quant
        self.mesh = mesh
        # single-slot engine reused for admission prefill
        self._prefill_engine = DuoEngine(params, cfg, duo, batch_size=1, dtype=dtype, device=self.device,
                                         kv_quant=kv_quant, mesh=mesh)
        # the pool rows this rank holds: its data group's slots [lo, lo + b), or all of them
        heads = None
        self._b, self._lo = max_batch_size, 0
        if mesh is not None:
            shards = pmesh.cache_shardings(mesh, cfg, duo, max_batch_size)
            heads, self._b, self._lo = shards.heads, shards.batch, shards.batch_start
        init = init_cache_q4 if kv_quant == "int4" else init_cache
        self.cache = init(cfg, duo, self._b, dtype, self.device, decode_only=True, heads=heads)
        self.cache.length = torch.zeros((self._b,), dtype=torch.int32, device=self.device)
        self.captures = self.device.type == "cuda" and (mesh is None or mesh.capturable)
        self.lengths = np.zeros(max_batch_size, np.int64)  # host mirror
        # a freed slot's device length, which it keeps until its next
        # admission (the INT4 decode reads its full-head rows up to it)
        self.stale = np.zeros(max_batch_size, np.int64)
        self._kv_sizes = None  # (pool bytes, full-head and streaming bytes a row a position), once traced
        # per-slot sampling state: host mirrors (greedy rows have temp 0) and
        # the device buffers the pool step reads
        self.samp_temp = np.zeros(max_batch_size, np.float32)
        self.samp_top_p = np.ones(max_batch_size, np.float32)
        self.samp_top_k = np.zeros(max_batch_size, np.int32)
        dev, B = self.device, self._b
        self.tokens = torch.zeros((B,), dtype=torch.long, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        # placeholder per-slot keys; admission installs PRNGKey(request seed)
        self.samp_keys = split(prng_key(0, dev), B)
        self._samp = (self.samp_keys, torch.zeros((B,), dtype=torch.float32, device=dev),
                      torch.ones((B,), dtype=torch.float32, device=dev),
                      torch.zeros((B,), dtype=torch.int32, device=dev))
        self.slots: List[Optional[Request]] = [None] * max_batch_size
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self._admitting = None  # (req, slot, row_cache, tokens prefilled so far)
        # recent scheduler events for tests/metrics, bounded
        self.trace = collections.deque(maxlen=4096)
        # With timing=True, step() keeps a view of its phases' spans
        # (``tracing``: ``serve.admit``, ``serve.decode``) in ``timings``:
        #   {"t", "event": "admit",  "rid", "tokens", "done", "dur_s"}
        #   {"t", "event": "decode", "steps", "produced", "live", "dur_s"}
        # ("t": seconds from the engine's creation to the span's start,
        # "dur_s": the span's host seconds). A mid-prompt admission chunk is
        # still followed by a device synchronize, inside its span, so its
        # duration is the chunk's (the final chunk and every decode burst
        # read their tokens back to the host, which waits anyway): the
        # benchmark's prefill/decode split of a profile relies on it. The
        # spans themselves never synchronize. ttft[rid] (seconds from submit
        # to first token) is recorded always.
        self.timing = timing
        self.timings = collections.deque(maxlen=65536)
        self.ttft: Dict[int, float] = {}
        self._clock0 = time.monotonic()
        self._wall0 = time.time_ns()  # the spans' clock at the same instant
        self._submit_t: Dict[int, float] = {}
        self._last_decode = None  # (steps, produced, live) from _decode_step
        self._graphs = {}  # (bucket, sampled) -> engine.StepGraph, on the card
        # Burst decoding: N decode steps between host round trips; a sequence
        # that finishes mid-burst costs a few wasted steps, its surplus tokens
        # trimmed on the host.
        self.decode_burst = max(int(decode_burst), 1)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request):
        req.generated = []
        req.prompt_len = len(req.prompt_ids)
        if req.prompt_len + req.max_new_tokens > self.duo.max_cache_size:
            raise ValueError(f"request {req.rid}: prompt + generation = {req.prompt_len + req.max_new_tokens} "
                             f"tokens exceeds max_cache_size = {self.duo.max_cache_size}")
        self._submit_t[req.rid] = time.monotonic()
        self.pending.append(req)

    def run(self, max_iters: int = 10_000) -> List[Request]:
        """Drive until all submitted work completes; returns finished.

        Raises if ``max_iters`` is exhausted with work still in flight, so a
        stalled scheduler is not mistaken for completion."""
        it = 0
        while (self.pending or self._admitting or any(self.slots)) and it < max_iters:
            self.step()
            it += 1
        if self.pending or self._admitting or any(self.slots):
            live = sum(r is not None for r in self.slots)
            raise RuntimeError(
                f"ServingEngine.run: max_iters={max_iters} exhausted with "
                f"{len(self.pending)} pending, {live} live slot(s), "
                f"admission {'in flight' if self._admitting else 'idle'} "
                f"({len(self.finished)} finished)")
        return self.finished

    def step(self):
        """One scheduler iteration, Sarathi-style: advance the in-flight
        admission by ONE prefill chunk (never a whole prompt), then run a
        decode burst for the live slots. At most one admission is in flight.
        Each phase is a span (``tracing``); with ``timing=True`` each is
        also kept in ``self.timings``."""
        with tracing.span("serve.step"):
            if self._admitting is None:
                free = [i for i, r in enumerate(self.slots) if r is None]
                if self.pending and free:
                    self._admitting = (self.pending.pop(0), free[0], None, 0)
            if self._admitting is not None:
                self._admit_traced()
            if any(r is not None for r in self.slots):
                with tracing.span("serve.decode", keep=self.timing, device=self.device, device_now=False) as sp:
                    self._decode_step(sp)
                if self.timing:
                    steps, produced, live = self._last_decode
                    self.timings.append({"t": (sp.t0 - self._wall0) / 1e9, "event": "decode", "steps": steps,
                                         "produced": produced, "live": live, "dur_s": sp.seconds})

    def _admit_traced(self):
        """One admission chunk in its ``serve.admit`` span."""
        req, _, _, off0 = self._admitting
        with tracing.span("serve.admit", rid=req.rid, keep=self.timing) as sp:
            self._admit_chunk()
            done = self._admitting is None
            if self.timing and not done and self.device.type == "cuda":  # mid-prompt chunk: wait for it
                torch.cuda.synchronize(self.device)
        if self.timing:
            tokens = (req.prompt_len if done else self._admitting[3]) - off0
            self.timings.append({"t": (sp.t0 - self._wall0) / 1e9, "event": "admit", "rid": req.rid,
                                 "tokens": tokens, "done": done, "dur_s": sp.seconds})

    def graph_captures(self) -> List[dict]:
        """The pool step's captures: bucket, sampled, the capture's seconds."""
        return [dict(bucket=b, sampled=s, seconds=g.seconds) for (b, s), g in self._graphs.items()]

    # -- internals ----------------------------------------------------------

    def _local(self, slot: int) -> Optional[int]:
        """The slot's row in this rank's pool, or None when another data
        group holds it."""
        row = slot - self._lo
        return row if 0 <= row < self._b else None

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """[B_local, ...] rows of the rank's slots -> [B, ...] of every slot."""
        return local if self.mesh is None else pmesh.gather_rows(self.mesh, local, self.B)

    @torch.no_grad()
    def _admit_chunk(self):
        req, slot, cache, off = self._admitting
        row = self._local(slot)
        C = self.duo.prefill_chunk_size
        chunk = req.prompt_ids[None, off : off + C]
        if row is not None:  # under a data split only the slot's data group prefills it
            cache, logits = self._prefill_engine.prefill(chunk, cache=cache, start=off)
        off += chunk.shape[1]
        self.trace.append(("admit", req.rid))
        if off < req.prompt_len:
            self._admitting = (req, slot, cache, off)
            return
        sp = req.sampling
        first = torch.zeros((1,), dtype=torch.long, device=self.device)
        if sp is not None and not sp.is_greedy:
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = sp.temperature, sp.top_p, sp.top_k
            if row is not None:
                vec = lambda v, dt: torch.full((1,), v, dtype=dt, device=self.device)  # noqa: E731
                toks, keys = sample_tokens_rowkeys(
                    logits.float(), prng_key(sp.seed, self.device)[None], vec(sp.temperature, torch.float32),
                    vec(sp.top_p, torch.float32), vec(sp.top_k, torch.int32))
                first = toks[:1]
                self.samp_keys[row].copy_(keys[0])
        else:
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = 0.0, 1.0, 0
            if row is not None:
                first = torch.argmax(logits, dim=-1)[:1]
        if self.mesh is not None:
            if row is not None:
                pmesh.broadcast(self.mesh, first)
            if self._b < self.B:  # the slot's group tells the others its first token
                first = pmesh.gather_rows(self.mesh, first.expand(self._b).clone(), self.B)[slot : slot + 1]
        first = int(first[0])
        if row is not None:
            _row_cache_to_batch(self.cache, cache, row)
            self.tokens[row] = first
        self.lengths[slot] = req.prompt_len
        self.stale[slot] = 0
        req.generated.append(first)
        self.ttft[req.rid] = time.monotonic() - self._submit_t.get(req.rid, self._clock0)
        req.slot = slot
        self.slots[slot] = req
        self._admitting = None
        self._maybe_finish(slot)

    def _pool_step(self, bucket: int, sample: bool) -> None:
        """One pool step on the static buffers: the next tokens land in
        ``self.tokens`` (and, sampled, the advanced keys in ``samp_keys``)."""
        self.tokens.copy_(_batched_decode_step(
            self.params, self.cfg, self.duo, self.cache, self.tokens, self._active,
            self._samp if sample else None, full_bucket=bucket, mesh=self.mesh))

    def pool_graph(self, bucket: int, sample: bool):
        """(the captured pool step for (bucket, sampled), whether it was
        captured by this call, its warm-up step having run one real step on
        the current buffers). On the card only."""
        graph = self._graphs.get((bucket, sample))
        if graph is not None:
            return graph, False
        graph = self._graphs[(bucket, sample)] = capture_step(
            lambda: self._pool_step(bucket, sample), capture_stream(self.device), self.cache,
            (self.tokens, self._active, *self._samp))
        return graph, True

    @torch.no_grad()
    def _decode_step(self, sp):
        """One decode burst for the live slots; ``sp`` is its span, which
        gets the burst's counts (``_burst_counts``) and its device time from
        before the first step to after the last token's copy."""
        active_np = np.array([r is not None for r in self.slots])
        maxlen = int(self.lengths.max())
        # Don't run past the cache. The request budget does not shrink the
        # burst: surplus tokens are trimmed on the host (as after a stop
        # token), so the step counts stay few.
        steps = max(min(self.decode_burst, self.duo.max_cache_size - 1 - maxlen), 1)
        bucket = min(_next_bucket(maxlen + steps), self.duo.max_cache_size)
        # the all-greedy pool skips the sampling sort entirely
        sample = bool(np.any(self.samp_temp[active_np] > 0.0))
        if sp:
            sp.set(steps=steps, **self._burst_counts(steps, bucket))
        rows = slice(self._lo, self._lo + self._b)  # the rank's slots
        self._active.copy_(torch.from_numpy(active_np[rows]))
        if sample:
            for buf, host in zip(self._samp[1:], (self.samp_temp, self.samp_top_p, self.samp_top_k)):
                buf.copy_(torch.from_numpy(host[rows]))
        seq = torch.empty((self._b, steps), dtype=torch.long, device=self.device)
        first = 0
        if self.captures:
            graph, captured = self.pool_graph(bucket, sample)
            sp.device_start()
            if captured:  # the capture's warm-up step was the burst's first step
                seq[:, 0].copy_(self.tokens)
                first = 1
            for t in range(first, steps):
                graph.replay()
                seq[:, t].copy_(self.tokens)
        else:
            sp.device_start()
            for t in range(steps):
                self._pool_step(bucket, sample)
                seq[:, t].copy_(self.tokens)
        sp.device_end()
        self.trace.append(("decode", steps))
        seq = self._gather(seq).cpu().numpy()  # [B, steps] (waits: the burst's timing is honest)
        tracing.resolve()
        produced = live = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            live += 1
            self.lengths[i] += steps
            for t in range(steps):
                req.generated.append(int(seq[i, t]))
                produced += 1
                self._maybe_finish(i)
                if self.slots[i] is None:  # finished mid-burst: trim the rest
                    break
        self._last_decode = (steps, produced, live)

    def _burst_counts(self, steps: int, bucket: int) -> dict:
        """A burst's counts, from host state alone, over this rank's rows
        and KV heads: its live rows' requests (``rids``); ``kv_pool_bytes``,
        the pool's KV buffers as allocated; ``kv_live_bytes``, what the live
        rows hold at the burst's start (full heads at the row's length,
        streaming heads at sink + recent at most); and the full-head K and V
        bytes the decode kernels read over the burst's steps, for live rows
        (``attn_full_live_bytes``: a row at length n reads n + t + 1
        positions at step t; the bucket covers them all) and for freed ones
        (``attn_full_dead_bytes``: none in a bf16 pool, whose decode kernel
        skips the rows the step's ``n_valid`` marks; an INT4 pool's decode
        reads a freed row's stale length, up to the bucket, at every step)."""
        if self._kv_sizes is None:
            c, n = self.cache, self._b
            full = sum(t.numel() * t.element_size() for name in c.BUFFERS if "full" in name
                       for t in getattr(c, name)) / (n * self.duo.max_cache_size)
            ring = sum(t.numel() * t.element_size() / t.shape[2] for t in (*c.k_ring, *c.v_ring)) / n
            self._kv_sizes = (kv_memory_bytes(c), full, ring)
        pool, full, ring = self._kv_sizes
        window = self.duo.sink_size + self.duo.recent_size
        rids, held, live_pos, dead_pos = [], 0.0, 0, 0
        for i in range(self._lo, self._lo + self._b):
            if self.slots[i] is not None:
                n = int(self.lengths[i])
                rids.append(self.slots[i].rid)
                held += n * full + min(n, window) * ring
                live_pos += steps * (n + 1) + steps * (steps - 1) // 2
            elif self.kv_quant == "int4":
                dead_pos += steps * min(int(self.stale[i]), bucket)
        return dict(rids=rids, kv_pool_bytes=pool, kv_live_bytes=held,
                    attn_full_live_bytes=live_pos * full, attn_full_dead_bytes=dead_pos * full)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        tok = req.generated[-1]
        if len(req.generated) >= req.max_new_tokens or tok in req.stop_token_ids:
            if tok in req.stop_token_ids:
                req.generated = req.generated[:-1] or req.generated
            req.done = True
            self.finished.append(req)
            self.slots[slot] = None
            self.stale[slot] = self.lengths[slot]
            self.lengths[slot] = 0
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = 0.0, 1.0, 0  # back to greedy
