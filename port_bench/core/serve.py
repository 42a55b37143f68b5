"""The serving cells' run: set-up, warm phase, window, traced span, check.

Set-up makes the weights from the seed (``core/weights.py``), hands them to
the program (``models.convert.reorder_params`` puts the configuration's
retrieval heads first), builds one ``ServingEngine`` and captures the pool's
decode graph for every bucket the mix's lengths reach. The warm phase runs
the traffic until every client has had a request admitted (closed loop) or
for ``warm_s`` seconds (open loop); set-up ends there and the window opens.
In the window the benchmark submits requests and calls ``step()``, and
after each call reads which tokens it can see, on its own clock.

With ``--trace 1`` the engine stamps its phases (``timing=True``) and the
first ``trace_iterations`` scheduler iterations of the window run under the
profiler; the per-layer readers take their numbers from that span.

Once the window has closed: the memory peak is read, a sample of the
finished requests (the longest, then others drawn from the seed, until
``check.served_tokens`` served tokens) is kept, the program's state is
freed, and the plain reference (``reference/model.py``) scores every
served token: how far its logit lies below the reference's best. Which
numbers are compared is the limits' business (``served_checks``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from . import counts, trace
from .harness import Context, Outcome, log
from .timeline import Timeline, serving_metrics
from .traffic import buckets, serving_stream
from .weights import Shape, make_params


def build_program(ctx: Context, params=None):
    """(params, cfg, duo) of the program: the configuration's published
    keys through the program's own reader, the weights with the retrieval
    heads first."""
    from duo_attention_tpu_torch.config import DuoConfig, config_from_hf_dict
    from duo_attention_tpu_torch.models.convert import reorder_params

    conf, d = ctx.conf, ctx.conf["duo"]
    cfg = config_from_hf_dict(conf)
    shape = Shape.of(conf)
    if params is None:
        params = make_params(shape, ctx.seed, ctx.device)
    binary = np.zeros((shape.layers, shape.kv_heads))
    for li, heads in enumerate(d["full_kv_heads"]):
        binary[li, heads] = 1.0
    params, num_full = reorder_params(params, cfg, binary)
    duo = DuoConfig(sink_size=d["sink_size"], recent_size=d["recent_size"], num_full_kv_heads=num_full,
                    max_cache_size=d["max_cache_size"], prefill_chunk_size=d["prefill_chunk_size"])
    return params, cfg, duo


class Loop:
    """The traffic's clock and bookkeeping around one engine."""

    def __init__(self, ctx: Context, eng, closed: bool):
        self.ctx, self.eng, self.closed = ctx, eng, closed
        self.stream = serving_stream(ctx.mix, ctx.seed, ctx.conf["vocab_size"])
        self.lines: Dict[int, Timeline] = {}
        self.reqs = {}
        self.seen: Dict[int, int] = {}
        self.open: List[int] = []
        self.next = 0
        self.t0 = None  # the stream's start (open loop)
        self.lateness = 0.0
        self.iters: List[dict] = []  # traced iterations' schedules
        self.admitted_tokens: Dict[int, int] = {}
        model = counts.Model.of(ctx.conf)
        per_head = model.shape.head_dim * 2 * counts.BF16  # K and V of one head at one position
        self.kv_full = sum(model.full) * per_head
        self.kv_stream = (model.shape.layers * model.shape.kv_heads - sum(model.full)) * per_head
        self.window_len = model.sink + model.recent

    def kv_held(self) -> int:
        """KV bytes that the pool's live rows hold: full heads at each row's
        length, streaming heads at sink + recent at most."""
        lengths = [int(self.eng.lengths[i]) for i, r in enumerate(self.eng.slots) if r is not None]
        return sum(n * self.kv_full + min(n, self.window_len) * self.kv_stream for n in lengths)

    def submit(self, due: float) -> None:
        from duo_attention_tpu_torch.serving import Request

        k = self.next
        self.next += 1
        req = Request(rid=k, prompt_ids=self.stream.prompt_ids(k), max_new_tokens=self.stream.max_new(k))
        self.eng.submit(req)
        self.reqs[k], self.lines[k], self.seen[k] = req, Timeline(due), 0
        self.open.append(k)

    def arrivals(self, now: float) -> None:
        """Open loop: submit every request due by now."""
        while self.t0 + self.stream.due(self.next) <= now:
            due = self.t0 + self.stream.due(self.next)
            self.lateness = max(self.lateness, now - due)
            self.submit(due)

    def observe(self, now: float) -> None:
        for k in list(self.open):
            req = self.reqs[k]
            n = len(req.generated)
            if n > self.seen[k]:
                self.lines[k].seen.append((now, n - self.seen[k]))
                self.seen[k] = n
            if req.done:
                self.open.remove(k)
                if self.closed:
                    self.submit(now)  # the client sends its next request at once

    def iterate(self, record: bool = False) -> None:
        eng = self.eng
        if not self.closed:
            self.arrivals(time.monotonic())
            if not self.open:  # nothing submitted is unfinished: wait for the next arrival
                time.sleep(max(0.0, min(self.t0 + self.stream.due(self.next) - time.monotonic(), 0.002)))
                return
        before = len(eng.timings)
        live = {i: int(eng.lengths[i]) for i, r in enumerate(eng.slots) if r is not None}
        eng.step()
        self.observe(time.monotonic())
        if record:
            self.iters.append(self.schedule(list(eng.timings)[before:], live))

    def schedule(self, events: List[dict], live: Dict[int, int]) -> dict:
        """One traced iteration: its admission chunk (start, tokens, seconds)
        and its decode burst (steps, each active row's length at the burst's
        start, seconds), from the engine's stamps and the host's lengths."""
        out = {"admit": None, "decode": None}
        lengths = list(live.values())
        for ev in events:
            if ev["event"] == "admit":
                start = self.admitted_tokens.get(ev["rid"], 0)
                self.admitted_tokens[ev["rid"]] = start + ev["tokens"]
                out["admit"] = {"start": start, "tokens": ev["tokens"], "seconds": ev["dur_s"]}
                if ev["done"]:
                    lengths.append(self.reqs[ev["rid"]].prompt_len)
            else:
                out["decode"] = {"steps": ev["steps"], "lengths": lengths, "seconds": ev["dur_s"],
                                 "live": ev["live"]}
        return out


def run_serving(ctx: Context, closed: bool, check: bool = True) -> Outcome:
    """One serving run. The sample of served requests that the check scores
    is handed back in ``notes["served"]``; with ``check=False`` the reference
    does not score it (the control scores it itself)."""
    import torch

    from duo_attention_tpu_torch.serving import ServingEngine

    mix, conf, dev = ctx.mix, ctx.conf, ctx.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)  # the allocator exists before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    t_imported = time.monotonic()
    params, cfg, duo = build_program(ctx)
    t_weights = time.monotonic()
    eng = ServingEngine(params, cfg, duo, max_batch_size=mix["slots"], decode_burst=mix["decode_burst"],
                        device=dev, timing=ctx.trace)
    loop = Loop(ctx, eng, closed)
    t_build = time.monotonic()
    if cuda:
        lo = mix["prompt"]["min"] + 1
        hi = mix["prompt"]["max"] + mix["output"]["max"] + mix["decode_burst"]
        for b in buckets(lo, hi, duo.max_cache_size):
            eng.pool_graph(b, False)
        torch.cuda.synchronize(dev)
    t_graphs = time.monotonic()

    # warm phase: the traffic itself, until steady state
    loop.t0 = time.monotonic()
    if closed:
        for _ in range(mix["clients"]):
            loop.submit(time.monotonic())
        first = list(loop.lines)
        while any(loop.lines[k].first_token() is None for k in first):
            loop.iterate()
    else:
        while time.monotonic() < loop.t0 + mix["warm_s"]:
            loop.iterate()
    if cuda:
        torch.cuda.synchronize(dev)
    w0 = time.monotonic()
    setup_s = w0 - ctx.t_start
    log(f"set-up {setup_s:.3f} s: start and imports {t_imported - ctx.t_start:.3f}, weights {t_weights - t_imported:.3f}, "
        f"engine {t_build - t_weights:.3f}, graphs {t_graphs - t_build:.3f}, "
        f"warm phase {w0 - loop.t0:.3f} ({loop.next} requests submitted)")

    # the window
    record, traced = None, None
    if ctx.trace:
        from .profile import device_breakdown
        from torch.profiler import record_function

        def span():
            for _ in range(mix["trace_iterations"]):
                with record_function(trace.STEP):
                    loop.iterate(record=True)

        t_prof = time.monotonic()
        frozen = device_breakdown(span)
        traced = trace.reduce(frozen.pop("events"), frozen["wall_ms"])
        log(trace.summary(traced) + f"\n  profiling and reading the span took {time.monotonic() - t_prof:.3f} s; "
            f"the frozen breakdown's idle share {frozen['idle_share']} (it counts the benchmark's ranges as device work)")
    held = [0.0, 0.0, 0.0]  # seconds, live-row seconds and KV-byte seconds of the untraced window
    while time.monotonic() < w0 + ctx.seconds:
        t, rows, kv = time.monotonic(), sum(r is not None for r in eng.slots), loop.kv_held()
        loop.iterate()
        dt = time.monotonic() - t
        held = [held[0] + dt, held[1] + rows * dt, held[2] + kv * dt]
    if cuda:
        torch.cuda.synchronize(dev)
    w1 = time.monotonic()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    e2e = serving_metrics(loop.lines, w0, w1)
    e2e["setup_s"] = setup_s
    attempted = sum(1 for tl in loop.lines.values() if w0 <= tl.due < w1)
    finished = sum(1 for k, r in loop.reqs.items() if r.done and w0 <= loop.lines[k].seen[-1][0] <= w1)
    notes = {"finished_in_window": finished, "open_at_close": len(loop.open), "generator_late_s": loop.lateness}
    log(f"window {w1 - w0:.3f} s: {attempted} requests due, {e2e['ttft_samples']} ttft samples, "
        f"{e2e['tpot_samples']} tpot samples, {sum(r.done for r in loop.reqs.values())} finished in all, "
        f"{len(loop.open)} open at the close, generator late by at most {loop.lateness * 1e3:.1f} ms")
    log("end to end, every metric of the traffic: " + ", ".join(f"{k} {v!r}" for k, v in e2e.items()))
    if held[0] > 0:
        log(f"untraced part of the window: {held[1] / held[0]:.3f} live rows and "
            f"{held[2] / held[0] / 1e9:.3f} GB of KV held by them on average, of "
            f"{mix['slots']} slots reserved")

    if ctx.trace:
        record = {"trace": traced, "iters": loop.iters, "model": counts.Model.of(conf), "conf": conf,
                  "ttft_p90_ms": e2e.get("ttft_p90_ms")}
    sample = choose_sample(loop, ctx)
    served = [(np.asarray(loop.reqs[k].prompt_ids), list(loop.reqs[k].generated)) for k in sample]
    del eng, params, loop.eng
    loop.reqs = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    notes["served"] = served
    out = Outcome(e2e=e2e, checks=served_checks(ctx, served) if check else [],
                  attempted=attempted, failed=0, memory_peak_bytes=peak, record=record, notes=notes)
    if traced is not None:
        out.busy_s, out.window_s, out.breakdown = traced["busy_s"], traced["window_s"], trace.breakdown(traced)
    return out


def choose_sample(loop: Loop, ctx: Context) -> List[int]:
    """The longest finished request, then finished requests drawn from the
    seed, until the sample holds ``check.served_tokens`` served tokens or
    ``check.max_requests`` requests. Each draw takes, in the seed's order,
    the next request served in the half of the pool that the sample holds
    fewer of, so any sample of two or more reads both halves of the batch."""
    done = [k for k, r in loop.reqs.items() if r.done]
    if not done:
        return []
    want, most = ctx.mix["check"]["served_tokens"], ctx.mix["check"]["max_requests"]
    longest = max(done, key=lambda k: (loop.reqs[k].prompt_len + len(loop.reqs[k].generated), -k))
    rest = [k for k in done if k != longest]
    order = np.random.default_rng([ctx.seed & ((1 << 64) - 1), 2]).permutation(len(rest))
    rest = [rest[i] for i in order]

    def half(k: int) -> int:
        return int(loop.reqs[k].slot >= ctx.mix["slots"] // 2)

    sample, tokens = [longest], len(loop.reqs[longest].generated)
    while rest and tokens < want and len(sample) < most:
        lower = sum(half(k) for k in sample) * 2 >= len(sample)  # the upper half holds as many or more
        pick = next((k for k in rest if half(k) == (0 if lower else 1)), rest[0])
        rest.remove(pick)
        sample.append(pick)
        tokens += len(loop.reqs[pick].generated)
    return sample


def judged(ctx: Context, g: np.ndarray, margins) -> np.ndarray:
    """The gaps that the check judges. A MoE configuration may set
    ``limits.served_router_margin``: a served token is judged only where the
    reference's router margin is at least that at every layer, since where
    two router logits nearly tie a last-bit difference picks another expert
    and the token's logits move by a whole expert's output."""
    floor = ctx.limits.get("served_router_margin")
    if floor is None or not margins:
        return g
    return g[np.concatenate(margins) >= floor]


def served_gaps(ctx: Context, served) -> np.ndarray:
    """How far each judged served token's logit lies below the reference's
    best logit at its position, over the sample (empty without one)."""
    from ..reference.model import gaps, logits_at

    if not served:
        return np.empty(0)
    t0 = time.monotonic()
    margins = []
    logits = logits_at(ctx.conf, ctx.seed, served, ctx.device, margins=margins)
    g = np.concatenate([gaps(lg, toks) for lg, (_, toks) in zip(logits, served)])
    kept = judged(ctx, g, margins)
    log(f"reference: {len(served)} requests, {len(g)} served tokens ({len(kept)} judged), prompts "
        f"{[len(p) for p, _ in served]}, {time.monotonic() - t0:.3f} s; gap median {float(np.median(g)):.5f}, "
        f"share at 0 {float(np.mean(g == 0)):.4f}, widest of all {float(g.max()):.5f}, mean of all "
        f"{float(g.mean()):.5f}")
    return kept


def served_checks(ctx: Context, served) -> list:
    """The numbers compared for a served model, as its limits name them:
    ``served_widest_gap`` (the widest judged gap) and ``served_mean_gap``
    (their mean). NaN where no token was judged."""
    g = served_gaps(ctx, served)
    value = {"served_widest_gap": lambda: float(g.max()), "served_mean_gap": lambda: float(g.mean())}
    return [(name, value[name]() if len(g) else float("nan"), limit)
            for name, limit in ctx.limits.items() if name in value]
