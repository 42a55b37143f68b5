"""The port's span recorder (``duo_attention_tpu_torch/tracing.py``) and
the spans and counters of the serving engine and the gate trainer.

On the CPU: nothing is recorded outside a profiler and ``recording()``; the
serving engine's spans nest (``serve.step`` > ``serve.admit`` >
``engine.prefill_chunk``, and ``serve.decode``) and carry the chunk tokens,
the live rows and the KV counters that a hand count gives; ``timing=True``'s
entries are the same spans' view; a running torch profiler turns recording
on, and its clock anchor puts a span inside the caller's range, one anchor
to each of two back-to-back profiler sessions; the trainer's step holds its
forward, backward and update; recording adds no operator to an iteration.
On the card (``cuda``): a captured burst gets a device time, and recording
adds no synchronize, no device-to-host copy and no operator to an
iteration.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from duo_attention_tpu_torch import DuoConfig, ModelConfig, Request, ServingEngine, tracing
from duo_attention_tpu_torch.config import PRESETS
from duo_attention_tpu_torch.models.llama import init_params
from duo_attention_tpu_torch.train.trainer import GateTrainConfig, GateTrainer

torch.set_num_threads(1)

FULL = (2, 1, 3)  # full KV heads of each of tiny-gqa's 3 layers (of 4)
SINK, RECENT, CHUNK = 4, 8, 16


@pytest.fixture(scope="module")
def model():
    cfg = PRESETS["tiny-gqa"]
    return init_params(cfg, 3, dtype=torch.float32, device="cpu"), cfg


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def duo_config(cfg, max_size=256):
    return DuoConfig(sink_size=SINK, recent_size=RECENT, num_full_kv_heads=FULL, max_cache_size=max_size,
                     prefill_chunk_size=CHUNK)


def engine(model, slots=2, burst=3, device="cpu", **kw):
    params, cfg = model
    return ServingEngine(params, cfg, duo_config(cfg), max_batch_size=slots, dtype=torch.float32,
                         decode_burst=burst, device=device, **kw)


def submit(eng, cfg, lengths, outs, seed=5):
    rng = np.random.default_rng(seed)
    for rid, (n, m) in enumerate(zip(lengths, outs)):
        eng.submit(Request(rid=rid, prompt_ids=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                           max_new_tokens=m))


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def position_bytes(cfg, elem=4):
    """K and V bytes of one position of one row: (full heads, streaming heads)."""
    per_head = cfg.head_dim * 2 * elem
    return sum(FULL) * per_head, (cfg.num_layers * cfg.num_kv_heads - sum(FULL)) * per_head


def test_nothing_is_recorded_outside_a_profiler_or_recording(model):
    eng = engine(model)
    submit(eng, model[1], (20, 40, 9), (4, 5, 3))
    eng.run()
    assert len(eng.finished) == 3
    assert tracing.spans() == [] and not tracing.active()


def test_serving_spans_nest_and_count(model):
    """3 requests through 2 slots: serve.step holds serve.admit, which holds
    engine.prefill_chunk, and serve.decode. Each rid's chunk tokens sum to
    its prompt, a burst's live rows are the engine's, and timing=True's
    entries are the spans' own stamps and counts."""
    cfg = model[1]
    eng = engine(model, timing=True)
    lengths = (20, 40, 9)
    submit(eng, cfg, lengths, (4, 6, 3))
    live_before = []
    with tracing.recording():
        while eng.pending or eng._admitting or any(eng.slots):
            eng.step()
            live_before.append(eng._last_decode)
    got = tracing.spans()
    ids = {s.id: s for s in got}
    steps, admits = by_name(got, "serve.step"), by_name(got, "serve.admit")
    chunks, bursts = by_name(got, "engine.prefill_chunk"), by_name(got, "serve.decode")
    assert len(steps) == len(live_before) and all(s.parent is None for s in steps)
    assert {ids[a.parent].name for a in admits} == {"serve.step"}
    assert {ids[b.parent].name for b in bursts} == {"serve.step"}
    assert {ids[c.parent].name for c in chunks} == {"serve.admit"}
    assert all(s.t0 <= s.t1 for s in got)
    for c in chunks:
        parent = ids[c.parent]
        assert parent.t0 <= c.t0 <= c.t1 <= parent.t1
    admitted = [e for e in eng.timings if e["event"] == "admit"]
    assert [ids[c.parent].rid for c in chunks] == [a.rid for a in admits] == [e["rid"] for e in admitted]
    assert [c.counts["tokens"] for c in chunks] == [e["tokens"] for e in admitted]
    for rid, n in enumerate(lengths):
        mine = [c.counts["tokens"] for c in chunks if ids[c.parent].rid == rid]
        assert sum(mine) == n and mine == [min(CHUNK, n - k) for k in range(0, n, CHUNK)]
        assert [e["done"] for e in admitted if e["rid"] == rid] == [False] * (len(mine) - 1) + [True]
    assert all(a.counts == {} for a in admits)
    timed = [e for e in eng.timings if e["event"] == "decode"]
    assert len(timed) == len(bursts)
    for b, e in zip(bursts, timed):
        assert len(b.counts["rids"]) == e["live"] and b.counts["steps"] == e["steps"]
        assert e["dur_s"] == b.seconds and b.device_ms is None
    assert [e["dur_s"] for e in admitted] == [a.seconds for a in admits]


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_dead_bytes_count_the_freed_rows_stale_lengths(model, kv_quant):
    """attn_full_dead_bytes is 0 while no slot has been freed. Once request 0
    has finished while request 1 decodes, its row keeps its device length;
    the full-head decode of a float32 or bf16 pool reads none of it (the
    step's n_valid marks it), so the count stays 0, while the INT4 decode
    reads that stale length (stopped at the bucket) at every step of each
    burst."""
    cfg = model[1]
    eng = engine(model, burst=2, kv_quant=kv_quant)
    # request 0 (10 tokens, 5 out): admitted with its first token, then 2 bursts of 2;
    # request 1 (30 tokens) is admitted in 2 chunks meanwhile, into slot 1
    submit(eng, cfg, (10, 30), (5, 12))
    with tracing.recording():
        eng.run()
    bursts = by_name(tracing.spans(), "serve.decode")
    assert [b.counts["rids"] for b in bursts[:3]] == [[0], [0], [1]]
    assert [b.counts["attn_full_dead_bytes"] for b in bursts[:2]] == [0, 0]
    stale = 10 + 2 + 2
    assert int(eng.stale[0]) == stale == int(eng.cache.length[0])
    full = eng._kv_sizes[1]  # full-head bytes a position, as the counter takes them
    if kv_quant == "none":
        assert full == position_bytes(cfg)[0]
    for b in bursts[2:]:  # the bucket (the cache's 256 positions) covers the stale length
        assert b.counts["rids"] == [1]
        assert b.counts["attn_full_dead_bytes"] == (b.counts["steps"] * stale * full if kv_quant == "int4" else 0)
    assert bursts[2].counts["attn_full_live_bytes"] == ((30 + 1) + (30 + 2)) * full


@pytest.mark.parametrize("fmt", ["w8a8", "bf16"])
def test_decode_reports_w8a8_weight_passes(model, fmt):
    """serve.decode's w8a8_weight_passes: how many times a pool step reads
    each int8 weight. A pool of 16 rows, SMALL_M_MAX, takes the small-M
    kernel's one pass over the weights: 1; a model without int8 weights: 0."""
    from duo_attention_tpu_torch.ops import gemm, quant

    params, cfg = model
    if fmt == "w8a8":
        params = quant.quantize_params_w8a8(params)
    eng = engine((params, cfg), slots=16, burst=2)
    submit(eng, cfg, (12, 7), (4, 3))
    with tracing.recording():
        eng.run()
    bursts = by_name(tracing.spans(), "serve.decode")
    assert bursts and gemm.SMALL_M_MAX == 16
    assert {b.counts["w8a8_weight_passes"] for b in bursts} == {1 if fmt == "w8a8" else 0}


def test_live_bytes_match_a_hand_count(model):
    """kv_live_bytes: each live row's full heads at its length and its
    streaming heads at sink + recent at most; attn_full_live_bytes: n + t + 1
    full-head positions a row at step t; kv_pool_bytes: every KV buffer."""
    cfg = model[1]
    full, stream = position_bytes(cfg)
    eng = engine(model, burst=3)
    submit(eng, cfg, (5, 23, 14), (9, 9, 4))
    lengths, burst = [], eng._decode_step

    def spy(sp):  # each burst's live rows' lengths at its start
        lengths.append({r.rid: int(eng.lengths[i]) for i, r in enumerate(eng.slots) if r is not None})
        burst(sp)

    eng._decode_step = spy
    with tracing.recording():
        eng.run()
    bursts = by_name(tracing.spans(), "serve.decode")
    assert len(bursts) == len(lengths) > 3
    pool = sum(t.numel() * t.element_size() for name in eng.cache.BUFFERS for t in getattr(eng.cache, name))
    for b, rows in zip(bursts, lengths):
        assert b.counts["rids"] == list(rows)
        ns, steps = list(rows.values()), b.counts["steps"]
        assert b.counts["kv_live_bytes"] == sum(n * full + min(n, SINK + RECENT) * stream for n in ns)
        assert b.counts["attn_full_live_bytes"] == sum(n + t + 1 for n in ns for t in range(steps)) * full
        assert b.counts["kv_pool_bytes"] == pool


def test_a_running_profiler_records_and_anchors_the_clock(model):
    """Inside torch.profiler.profile spans are recorded, with a session;
    the CLOCK range is among the profile's events, and a span put on the
    profile's timeline through it lies within 2 ms of the caller's range
    around it. Leaving the profiler turns recording off."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = model[1]
    eng = engine(model)
    submit(eng, cfg, (20, 12), (3, 3))
    eng.step()  # outside the profiler: nothing
    assert tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        with record_function("caller"):
            eng.step()
    assert not tracing.active()
    got = tracing.spans()
    assert got and {s.session for s in got} == {got[0].session} and got[0].session is not None
    events = prof.events()
    clock = [e for e in events if e.name == tracing.CLOCK]
    caller = [e for e in events if e.name == "caller"][0]
    assert len(clock) == 1
    off = tracing.offset_us(got[0].session, clock[0].time_range.start, clock[0].time_range.end)
    (step,) = by_name(got, "serve.step")
    t0, t1 = step.t0 / 1e3 - off, step.t1 / 1e3 - off
    assert caller.time_range.start - 2000 <= t0 <= t1 <= caller.time_range.end + 2000
    eng.run()  # after the profiler: nothing more
    assert len(tracing.spans()) == len(got)


def test_back_to_back_profiler_sessions_each_get_an_anchor(model):
    """Two profiler sessions with no span between them: each session's
    spans carry their own session, each profile holds one CLOCK range, and
    each session's spans, put on their own profile's timeline through it,
    lie inside the caller's range there."""
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = engine(model)
    submit(eng, model[1], (20, 12, 30), (3, 3, 3))
    profiles = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller"):
                eng.step()
        profiles.append(prof)
    sessions = sorted({s.session for s in tracing.spans()})
    assert len(sessions) == 2 and None not in sessions
    for session, prof in zip(sessions, profiles):
        events = prof.events()
        (clock,) = [e for e in events if e.name == tracing.CLOCK]
        (caller,) = [e for e in events if e.name == "caller"]
        off = tracing.offset_us(session, clock.time_range.start, clock.time_range.end)
        (step,) = [s for s in tracing.spans() if s.session == session and s.name == "serve.step"]
        assert caller.time_range.start - 2000 <= step.t0 / 1e3 - off <= step.t1 / 1e3 - off \
            <= caller.time_range.end + 2000


def test_gate_trainer_step_holds_forward_backward_update(model, tmp_path):
    params, cfg = model
    tcfg = GateTrainConfig(lr=0.05, num_steps=4, warmup_steps=1, sink_size=8, recent_size=16, block_k=32,
                           output_dir=str(tmp_path))
    trainer = GateTrainer(params, cfg, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (1, 64))
    labels = np.full_like(ids, -100)
    labels[:, 50:] = ids[:, 50:]
    with tracing.recording():
        loss = trainer.train_step(ids, labels)[0]
    assert np.isfinite(loss)
    got = tracing.spans()
    (step,) = by_name(got, "train.step")
    assert step.counts == {} and step.parent is None
    children = [s for s in got if s.parent == step.id]
    assert [s.name for s in children] == ["train.forward", "train.backward", "train.update"]
    assert all(step.t0 <= s.t0 <= s.t1 <= step.t1 for s in children)
    assert all(s.device_ms is None for s in got)


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched, and those that copy from the card to
    the host."""

    def __init__(self):
        super().__init__()
        self.ops, self.to_host = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        out = func(*args, **kwargs)
        srcs = [a for a in args if isinstance(a, torch.Tensor) and a.is_cuda]
        if func is torch.ops.aten._local_scalar_dense.default and srcs:
            self.to_host += 1
        elif srcs and isinstance(out, torch.Tensor) and out.device.type == "cpu":
            self.to_host += 1
        return out


def iteration_costs(eng, record: bool, monkeypatch):
    """(operators, device-to-host copies, synchronizes) of one scheduler
    iteration, recording or not."""
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (syncs.append(1), real(*a, **k))[1])
    mode = _Ops()
    with (tracing.recording() if record else contextlib.nullcontext()), mode:
        eng.step()
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    return mode.ops, mode.to_host, len(syncs)


def twin_engines(model, device, **kw):
    """Two engines on the same params and requests, in the same state."""
    engines = [engine(model, slots=2, burst=4, device=device, **kw) for _ in range(2)]
    for eng in engines:
        submit(eng, model[1], (40, 20, 33), (12, 12, 12))
    return engines


def test_recording_adds_no_operator_to_an_iteration(model, monkeypatch):
    """Iteration by iteration, an engine recording dispatches the operators
    its twin not recording does, on the CPU."""
    off, on = twin_engines(model, "cpu", timing=True)
    while off.pending or off._admitting or any(off.slots):
        assert iteration_costs(on, True, monkeypatch) == iteration_costs(off, False, monkeypatch)
    assert [r.generated for r in on.finished] == [r.generated for r in off.finished]
    assert by_name(tracing.spans(), "serve.decode")


@pytest.mark.cuda
def test_recording_on_the_card_adds_no_sync_copy_or_kernel(monkeypatch):
    """On the card, with the pool step replayed from CUDA graphs: recorded
    bursts and prefill chunks get positive device times (an admission span
    takes none), and each iteration
    recording makes the synchronizes, device-to-host copies and operators
    its twin not recording makes (timing=True's synchronize after a
    mid-prompt chunk included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=4, head_dim=128, model_type="llama")
    duo = DuoConfig(sink_size=16, recent_size=64, num_full_kv_heads=(2, 1), max_cache_size=1024,
                    prefill_chunk_size=256)
    params = init_params(cfg, 3, device="cuda")
    twins = [ServingEngine(params, cfg, duo, max_batch_size=2, decode_burst=4, device="cuda", timing=True)
             for _ in range(2)]
    for eng in twins:
        submit(eng, cfg, (300, 70, 180), (12, 12, 12))
        eng.pool_graph(512, False)  # every burst's bucket, captured before the iterations
    torch.cuda.synchronize()
    off, on = twins
    while off.pending or off._admitting or any(off.slots):
        assert iteration_costs(on, True, monkeypatch) == iteration_costs(off, False, monkeypatch)
    assert [r.generated for r in on.finished] == [r.generated for r in off.finished]
    assert len(on._graphs) == 1
    torch.cuda.synchronize()
    got = tracing.spans()
    for name in ("serve.decode", "engine.prefill_chunk"):
        assert by_name(got, name) and all(s.device_ms > 0 for s in by_name(got, name)), name
    assert by_name(got, "serve.admit") and all(s.device_ms is None for s in by_name(got, "serve.admit"))
