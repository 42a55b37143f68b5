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
  keeps its KV and its device length, which may pass the pool's bucket: the
  kernels read no key past the bucket, its row's output is discarded, and
  the next admission overwrites it.

On the card the pool step is captured once per (bucket, sampled) into a CUDA
graph (``engine.capture_step``) on the pool cache, which persists:
admissions, slot reuse and later bursts replay the same graph. The tokens,
the active mask, and the per-slot sampling vectors and keys live in static
device buffers that the host refills between bursts. Admission prefill and
pool decode run on one stream: the decode kernels' scratch
(``ops/flash.py::_scratch``) is shared by every caller on a device. On the
CPU the same step runs eagerly.

Not ported yet: meshes.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .cache import init_cache, init_cache_q4, ring_slot_positions
from .config import DuoConfig, ModelConfig
from .engine import DuoEngine, _next_bucket, capture_step, capture_stream
from .models import llama
from .ops.sampling import SamplingParams, prng_key, sample_tokens_rowkeys, split
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
                         active: torch.Tensor, samp=None, *, full_bucket: int) -> torch.Tensor:
    """One decode step for every slot; inactive slots do not advance.

    tokens [B] int64; active [B] bool. samp: None for all-greedy, else (keys
    [B, 2], temperature [B], top_p [B], top_k [B]); each row draws on its own
    key, and the advanced keys are written back into ``keys`` in place.
    Returns the next tokens [B] (an inactive row keeps its token)."""
    hidden, cache = llama.forward_chunk(params, cfg, duo, cache, tokens[:, None],
                                        n_valid=active.to(torch.int32), full_bucket=full_bucket)
    logits = llama.logits_at(params, hidden, 0)  # [B, vocab]
    if samp is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        keys, temp, top_p, top_k = samp
        nxt, keys_next = sample_tokens_rowkeys(logits.float(), keys, temp, top_p, top_k)
        keys.copy_(keys_next)
    return torch.where(active, nxt, tokens)


class ServingEngine:
    """Continuous-batching engine over a fixed pool of batch slots."""

    def __init__(self, params, cfg: ModelConfig, duo: DuoConfig, max_batch_size: int = 4,
                 dtype=torch.bfloat16, kv_quant: str = "none", decode_burst: int = 1,
                 device="cuda", timing: bool = False):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.duo = duo
        self.B = max_batch_size
        self.kv_quant = kv_quant
        # single-slot engine reused for admission prefill
        self._prefill_engine = DuoEngine(params, cfg, duo, batch_size=1, dtype=dtype, device=self.device,
                                         kv_quant=kv_quant)
        init = init_cache_q4 if kv_quant == "int4" else init_cache
        self.cache = init(cfg, duo, max_batch_size, dtype, self.device, decode_only=True)
        self.cache.length = torch.zeros((max_batch_size,), dtype=torch.int32, device=self.device)
        self.lengths = np.zeros(max_batch_size, np.int64)  # host mirror
        # per-slot sampling state: host mirrors (greedy rows have temp 0) and
        # the device buffers the pool step reads
        self.samp_temp = np.zeros(max_batch_size, np.float32)
        self.samp_top_p = np.ones(max_batch_size, np.float32)
        self.samp_top_k = np.zeros(max_batch_size, np.int32)
        dev, B = self.device, max_batch_size
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
        # With timing=True, step() stamps each phase into ``timings``:
        #   {"t", "event": "admit",  "rid", "tokens", "done", "dur_s"}
        #   {"t", "event": "decode", "steps", "produced", "live", "dur_s"}
        # A mid-prompt admission chunk is followed by a device synchronize so
        # its duration is the chunk's (the final chunk and every decode burst
        # read their tokens back to the host, which waits anyway). ttft[rid]
        # (seconds from submit to first token) is recorded always.
        self.timing = timing
        self.timings = collections.deque(maxlen=65536)
        self.ttft: Dict[int, float] = {}
        self._clock0 = time.monotonic()
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
        With ``timing=True`` each phase is stamped into ``self.timings``."""
        admitted, off0 = None, 0
        t0 = time.monotonic()
        if self._admitting is not None:
            admitted, off0 = self._admitting[0], self._admitting[3]
            self._admit_chunk()
        else:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if self.pending and free:
                req = self.pending.pop(0)
                self._admitting = (req, free[0], None, 0)
                admitted = req
                self._admit_chunk()
        if self.timing and admitted is not None:
            if self._admitting is not None:  # mid-prompt chunk: wait for it
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                off_now = self._admitting[3]
            else:
                off_now = admitted.prompt_len  # final chunk (its first token was read back)
            self.timings.append({"t": t0 - self._clock0, "event": "admit", "rid": admitted.rid,
                                 "tokens": off_now - off0, "done": self._admitting is None,
                                 "dur_s": time.monotonic() - t0})
        if any(r is not None for r in self.slots):
            t1 = time.monotonic()
            self._decode_step()
            if self.timing:
                steps, produced, live = self._last_decode
                self.timings.append({"t": t1 - self._clock0, "event": "decode", "steps": steps,
                                     "produced": produced, "live": live, "dur_s": time.monotonic() - t1})

    def graph_captures(self) -> List[dict]:
        """The pool step's captures: bucket, sampled, the capture's seconds."""
        return [dict(bucket=b, sampled=s, seconds=g.seconds) for (b, s), g in self._graphs.items()]

    # -- internals ----------------------------------------------------------

    @torch.no_grad()
    def _admit_chunk(self):
        req, slot, cache, off = self._admitting
        C = self.duo.prefill_chunk_size
        chunk = req.prompt_ids[None, off : off + C]
        cache, logits = self._prefill_engine.prefill(chunk, cache=cache, start=off)
        off += chunk.shape[1]
        self.trace.append(("admit", req.rid))
        if off < req.prompt_len:
            self._admitting = (req, slot, cache, off)
            return
        sp = req.sampling
        if sp is not None and not sp.is_greedy:
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = sp.temperature, sp.top_p, sp.top_k
            vec = lambda v, dt: torch.full((1,), v, dtype=dt, device=self.device)  # noqa: E731
            toks, keys = sample_tokens_rowkeys(
                logits.float(), prng_key(sp.seed, self.device)[None], vec(sp.temperature, torch.float32),
                vec(sp.top_p, torch.float32), vec(sp.top_k, torch.int32))
            first = int(toks[0])
            self.samp_keys[slot].copy_(keys[0])
        else:
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = 0.0, 1.0, 0
            first = int(torch.argmax(logits, dim=-1)[0])
        _row_cache_to_batch(self.cache, cache, slot)
        self.tokens[slot] = first
        self.lengths[slot] = req.prompt_len
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
            self._samp if sample else None, full_bucket=bucket))

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
    def _decode_step(self):
        active_np = np.array([r is not None for r in self.slots])
        maxlen = int(self.lengths.max())
        # Don't run past the cache. The request budget does not shrink the
        # burst: surplus tokens are trimmed on the host (as after a stop
        # token), so the step counts stay few.
        steps = max(min(self.decode_burst, self.duo.max_cache_size - 1 - maxlen), 1)
        bucket = min(_next_bucket(maxlen + steps), self.duo.max_cache_size)
        # the all-greedy pool skips the sampling sort entirely
        sample = bool(np.any(self.samp_temp[active_np] > 0.0))
        self._active.copy_(torch.from_numpy(active_np))
        if sample:
            for buf, host in zip(self._samp[1:], (self.samp_temp, self.samp_top_p, self.samp_top_k)):
                buf.copy_(torch.from_numpy(host))
        seq = torch.empty((self.B, steps), dtype=torch.long, device=self.device)
        first = 0
        if self.device.type == "cuda":
            graph, captured = self.pool_graph(bucket, sample)
            if captured:  # the capture's warm-up step was the burst's first step
                seq[:, 0].copy_(self.tokens)
                first = 1
            for t in range(first, steps):
                graph.replay()
                seq[:, t].copy_(self.tokens)
        else:
            for t in range(steps):
                self._pool_step(bucket, sample)
                seq[:, t].copy_(self.tokens)
        self.trace.append(("decode", steps))
        seq = seq.cpu().numpy()  # [B, steps] (waits: the burst's timing is honest)
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

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        tok = req.generated[-1]
        if len(req.generated) >= req.max_new_tokens or tok in req.stop_token_ids:
            if tok in req.stop_token_ids:
                req.generated = req.generated[:-1] or req.generated
            req.done = True
            self.finished.append(req)
            self.slots[slot] = None
            self.lengths[slot] = 0
            self.samp_temp[slot], self.samp_top_p[slot], self.samp_top_k[slot] = 0.0, 1.0, 0  # back to greedy
