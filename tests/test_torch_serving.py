"""The port's continuous-batching ServingEngine, on the CPU, against its own
isolated DuoEngine and against the JAX package's ServingEngine.

Counterparts of every test of tests/test_serving.py but the mesh one (that
one is tests/test_torch_parallel.py's): serving N requests through the shared pool (staggered
admissions, per-sequence lengths, slot reuse) gives exactly the tokens
isolated single-request generation gives, in the float32 cache and in the
INT4 one; and the JAX ServingEngine, fed the same numpy-drawn weights, gives
the same tokens. The splice test holds the pool row after
``_row_cache_to_batch`` to JAX's buffer by buffer, the ring re-base included.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu import serving as jserving
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch import DuoEngine, Request, ServingEngine
from duo_attention_tpu_torch import serving as tserving
from test_torch_model import duos, models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    tcfg, jcfg, tp, jp = models("tiny-gqa", 3)
    tduo, jduo = duos(tcfg, (2, 1, 3), sink=8, recent=16, chunk=32, max_size=256)
    return tp, tcfg, tduo, jp, jcfg, jduo


def isolated_tokens(params, cfg, duo, prompt, n, kv_quant="none"):
    eng = DuoEngine(params, cfg, duo, dtype=torch.float32, device="cpu", kv_quant=kv_quant)
    toks, _ = eng.generate(prompt[None, :], max_new_tokens=n)
    return list(map(int, toks[0]))


def serve(params, cfg, duo, prompts, n, **kw):
    eng = ServingEngine(params, cfg, duo, dtype=torch.float32, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt_ids=p, max_new_tokens=n))
    finished = eng.run()
    assert len(finished) == len(prompts)
    return {r.rid: r.generated for r in finished}, eng


def jax_serve(params, cfg, duo, prompts, n, **kw):
    eng = jserving.ServingEngine(params, cfg, duo, dtype=jnp.float32, attn_impl="ref", **kw)
    for i, p in enumerate(prompts):
        eng.submit(jserving.Request(rid=i, prompt_ids=p, max_new_tokens=n))
    return {r.rid: list(map(int, r.generated)) for r in eng.run()}


def prompts_of(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_serving_matches_isolated_and_jax(setup, kv_quant):
    """Served tokens equal isolated port generation and the JAX
    ServingEngine's, in the float32 pool and the INT4 one (bursts of 3)."""
    tp, tcfg, tduo, jp, jcfg, jduo = setup
    prompts = prompts_of(tcfg, 21, (40, 70, 25))
    got, _ = serve(tp, tcfg, tduo, prompts, 5, max_batch_size=2, kv_quant=kv_quant, decode_burst=3)
    for i, p in enumerate(prompts):
        assert got[i] == isolated_tokens(tp, tcfg, tduo, p, 5, kv_quant), f"request {i}"
    assert got == jax_serve(jp, jcfg, jduo, prompts, 5, max_batch_size=2, kv_quant=kv_quant, decode_burst=3)


def test_serving_matches_isolated(setup):
    tp, tcfg, tduo = setup[:3]
    prompts = prompts_of(tcfg, 0, (17, 50, 33, 70))  # mixed: some cross chunk boundaries
    got, _ = serve(tp, tcfg, tduo, prompts, 6, max_batch_size=2)
    for i, p in enumerate(prompts):
        assert got[i] == isolated_tokens(tp, tcfg, tduo, p, 6), f"request {i} diverged"


def test_serving_stop_tokens_and_slot_reuse(setup):
    tp, tcfg, tduo = setup[:3]
    prompts = prompts_of(tcfg, 1, (20, 20, 20))
    # each prompt's 3rd greedy token is that request's stop token
    stops = [isolated_tokens(tp, tcfg, tduo, p, 3)[2] for p in prompts]
    eng = ServingEngine(tp, tcfg, tduo, max_batch_size=1, dtype=torch.float32, device="cpu")
    for i, (p, s) in enumerate(zip(prompts, stops)):
        eng.submit(Request(rid=i, prompt_ids=p, max_new_tokens=10, stop_token_ids=(int(s),)))
    finished = eng.run()
    assert len(finished) == 3
    for r, p, s in zip(sorted(finished, key=lambda r: r.rid), prompts, stops):
        iso = isolated_tokens(tp, tcfg, tduo, p, 3)
        # the stream up to the stop token's first appearance, which is trimmed
        assert r.generated == (iso[: iso.index(s)] or [s])


def test_batched_cache_lengths_advance_only_active(setup):
    tp, tcfg, tduo = setup[:3]
    p = prompts_of(tcfg, 2, (12,))[0]
    _, eng = serve(tp, tcfg, tduo, [p], 4, max_batch_size=3)
    lengths = eng.cache.length.numpy()
    # slot 0 advanced by prompt + decoded tokens - 1 (the last token is not
    # fed back); slots 1-2 untouched
    assert lengths[0] == 12 + 3
    assert lengths[1] == 0 and lengths[2] == 0


def test_burst_decode_matches_single_step(setup):
    """decode_burst=N is a pure scheduling change: same tokens out."""
    tp, tcfg, tduo = setup[:3]
    prompts = prompts_of(tcfg, 7, (21, 45, 60))
    results = {}
    for burst in (1, 4):
        eng = ServingEngine(tp, tcfg, tduo, max_batch_size=2, dtype=torch.float32, device="cpu",
                            decode_burst=burst)
        for i, p in enumerate(prompts):
            # a stop token forces a mid-burst finish for at least one request
            eng.submit(Request(rid=i, prompt_ids=p, max_new_tokens=9, stop_token_ids=(3,)))
        finished = eng.run()
        assert len(finished) == len(prompts)
        results[burst] = {r.rid: r.generated for r in finished}
    assert results[1] == results[4]


def test_admission_interleaves_with_decode(setup):
    """While a long prompt is admitted chunk by chunk, the live slots keep
    decoding between its chunks."""
    tp, tcfg, tduo = setup[:3]
    short, long = prompts_of(tcfg, 11, (20, 5 * tduo.prefill_chunk_size))
    eng = ServingEngine(tp, tcfg, tduo, max_batch_size=2, dtype=torch.float32, device="cpu")
    eng.submit(Request(rid=0, prompt_ids=short, max_new_tokens=12))
    eng.submit(Request(rid=1, prompt_ids=long, max_new_tokens=2))
    finished = eng.run()
    assert len(finished) == 2
    admits1 = [i for i, e in enumerate(eng.trace) if e == ("admit", 1)]
    assert len(admits1) == 5
    between = [i for i, e in enumerate(eng.trace) if e[0] == "decode" and admits1[0] < i < admits1[-1]]
    assert between, f"no interleaved decode: {eng.trace}"
    for r in finished:
        p = short if r.rid == 0 else long
        assert r.generated == isolated_tokens(tp, tcfg, tduo, p, r.max_new_tokens)


def test_serving_int4_matches_isolated(setup):
    """INT4 pool: the admission splice and the compact-ring re-base over the
    quantized cache give isolated INT4 generation's tokens."""
    tp, tcfg, tduo = setup[:3]
    prompts = prompts_of(tcfg, 22, (40, 70, 25, 33))
    got, _ = serve(tp, tcfg, tduo, prompts, 5, max_batch_size=2, kv_quant="int4", decode_burst=3)
    for i, p in enumerate(prompts):
        assert got[i] == isolated_tokens(tp, tcfg, tduo, p, 5, "int4"), f"request {i}"


def test_engine_timing_trace(setup):
    """timing=True: step() emits admit/decode events with honest token
    counts, and TTFT is recorded per request."""
    tp, tcfg, tduo = setup[:3]
    prompts = prompts_of(tcfg, 1, (40, 70))
    eng = ServingEngine(tp, tcfg, tduo, max_batch_size=2, dtype=torch.float32, device="cpu", timing=True)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt_ids=p, max_new_tokens=5))
    finished = eng.run()
    assert len(finished) == 2
    events = list(eng.timings)
    admits = [e for e in events if e["event"] == "admit"]
    decodes = [e for e in events if e["event"] == "decode"]
    # chunked admission: 40 -> 32 + 8, 70 -> 32 + 32 + 6 (chunk size 32)
    assert sum(e["tokens"] for e in admits if e["rid"] == 0) == 40
    assert sum(e["tokens"] for e in admits if e["rid"] == 1) == 70
    assert sum(e["done"] for e in admits) == 2
    total = sum(len(r.generated) for r in finished)
    assert sum(e["produced"] for e in decodes) == total - 2
    assert all(e["dur_s"] >= 0 for e in events)
    assert set(eng.ttft) == {0, 1} and all(v > 0 for v in eng.ttft.values())


def test_run_raises_when_iterations_run_out(setup):
    tp, tcfg, tduo = setup[:3]
    eng = ServingEngine(tp, tcfg, tduo, max_batch_size=1, dtype=torch.float32, device="cpu")
    eng.submit(Request(rid=0, prompt_ids=prompts_of(tcfg, 3, (70,))[0], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="max_iters=2 exhausted"):
        eng.run(max_iters=2)


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_splice_matches_jax_buffer_by_buffer(setup, kv_quant):
    """``_row_cache_to_batch`` on the same numpy data in both packages: every
    pool buffer equals JAX's bitwise (INT4 scales: the 4 rows a head the port
    keeps of JAX's 8), written in place, the sink cut to the pool's rows and the ring re-based from
    the admission R to the pool R, and the slot's length; the other rows
    are untouched. The row's length wraps the admission ring."""
    _, tcfg, tduo, _, jcfg, jduo = setup
    rng = np.random.default_rng(5)
    q4 = kv_quant == "int4"
    jinit = jcache.init_cache_q4 if q4 else jcache.init_cache
    tinit = tcache.init_cache_q4 if q4 else tcache.init_cache

    def host(arr, name):
        """A JAX buffer as a numpy array in the port's layout."""
        a = np.asarray(arr) if arr.dtype == jnp.uint8 else np.asarray(arr.astype(jnp.float32))
        if name.endswith("_s"):  # JAX's [B, 8 Hf, T/2]: 8 rows a head, the first 4 the port's
            a = a.reshape(a.shape[0], -1, 8, a.shape[-1])[:, :, :4]
        return a

    def fill(jc, tc, length):
        """Random data into both caches, identical."""
        upd = {}
        for name in tc.BUFFERS:
            arrs = []
            for jb, tb in zip(getattr(jc, name), getattr(tc, name)):
                if jb.dtype == jnp.uint8:
                    a = jnp.asarray(rng.integers(0, 256, jb.shape), jnp.uint8)
                else:
                    a = jnp.asarray(rng.standard_normal(jb.shape), jb.dtype)
                arrs.append(a)
                tb.copy_(torch.from_numpy(np.array(host(a, name))).to(tb.dtype))
            upd[name] = tuple(arrs)
        tc.length = torch.as_tensor(np.asarray(length), dtype=torch.int32)
        return jc._replace(**upd, length=jnp.asarray(length, jnp.int32)), tc

    R_adm = tcache.ring_capacity(tduo)
    row_len = R_adm + 45  # the admission ring has wrapped
    jrow, trow = fill(jinit(jcfg, jduo, 1, jnp.float32), tinit(tcfg, tduo, 1, torch.float32, "cpu"), row_len)
    jpool, tpool = fill(jinit(jcfg, jduo, 3, jnp.float32, decode_only=True),
                        tinit(tcfg, tduo, 3, torch.float32, "cpu", decode_only=True), [7, 9, 11])
    assert tpool.k_ring[0].shape[2] == tcache.ring_capacity(tduo, decode_only=True) < R_adm
    before = {name: [t.clone() for t in getattr(tpool, name)] for name in tpool.BUFFERS}
    tensors = {name: list(getattr(tpool, name)) for name in tpool.BUFFERS}
    jout = jserving._row_cache_to_batch(jpool, jrow, 1)
    tserving._row_cache_to_batch(tpool, trow, 1)
    for name in tpool.BUFFERS:
        for li, (jb, tb) in enumerate(zip(getattr(jout, name), getattr(tpool, name))):
            assert tb is tensors[name][li], f"{name}[{li}] was rebound, not written in place"
            got = tb.numpy() if tb.dtype == torch.uint8 else tb.float().numpy()
            np.testing.assert_array_equal(got, host(jb, name), err_msg=f"{name}[{li}]")
            for row in (0, 2):
                assert torch.equal(tb[row], before[name][li][row]), f"{name}[{li}] row {row} changed"
    np.testing.assert_array_equal(tpool.length.numpy(), np.asarray(jout.length))
    assert tpool.length.tolist() == [7, row_len, 11]


def test_serving_bench_runs_and_reports(tmp_path):
    """evals/serving_bench.py at a tiny geometry on the CPU: more requests
    than slots, every token generated, the JAX bench's report keys."""
    from duo_attention_tpu_torch.evals import serving_bench

    argv = ["--preset", "tiny-gqa", "--device", "cpu", "--prompt-lens", "40,70,25", "--max-new", "4",
            "--slots", "2", "--decode-burst", "2", "--prefill-chunk", "32", "--no-warmup-run",
            "--out-dir", str(tmp_path)]
    serving_bench.main(argv)
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    assert set(report) == {"config", "aggregate", "per_token_latency_s", "admission_stall_s", "requests", "trace"}
    agg = report["aggregate"]
    assert agg["requests"] == 3 and agg["total_generated_tokens"] == 3 * 4
    assert agg["prefill_tokens"] == 135 and report["config"]["max_cache_size"] == 8192
    assert report["admission_stall_s"]["count"] == 2 + 3 + 1  # chunks of 32
    assert [r["generated"] for r in report["requests"]] == [4, 4, 4]
    assert report["per_token_latency_s"]["n"] > 0
