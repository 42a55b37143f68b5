"""Tensor parallelism of the port (duo_attention_tpu_torch/parallel/) against
the JAX package, on the CPU.

Counterparts of tests/test_spmd.py (data 2 x tensor 2 generation, mixed head
divisibility, expert parallelism, W8A8 TP, the 131,072-token sharded INT4
decode; the 1M-token case is ``slow`` in JAX and stays out here too) and of
tests/test_serving.py::test_serving_tp_matches_isolated, then the TP dry runs
and the rules themselves. The port's ranks are new processes: gloo, float32,
the plain versions of the kernels, one intra-op thread each, spawned by
``parallel.mesh.run_ranks`` (which kills every rank of a run that fails or
outlasts SPAWN_TIMEOUT_S) with a ``file://`` store under ``tmp_path``. Each
mesh is spawned once (a module fixture) and runs the jobs of several tests.
JAX runs its GSPMD engine in this process, on the 8 virtual CPU devices of
tests/conftest.py (``attn_impl="ref"``, the partitionable path).
"""

import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.engine import DuoEngine as JDuoEngine
from duo_attention_tpu.parallel.mesh import build_mesh as j_build_mesh
from duo_attention_tpu.parallel.mesh import shard_params as j_shard_params
from duo_attention_tpu_torch import DuoEngine, SamplingParams, init_params, load_attn_pattern, sparsify_attention_heads
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch.ops import launches, quant
from duo_attention_tpu_torch.parallel import mesh as pmesh
from duo_attention_tpu_torch.patterns import num_full_kv_heads_per_layer
from test_torch_model import duos, models
from test_torch_quant import FLIP_LOGIT_GAP, FLIP_REL_FRO, TIGHT_ATOL, rel_fro, w8a8_models

torch.set_num_threads(1)
SPAWN_TIMEOUT_S = 240
REPO = Path(__file__).resolve().parent.parent
W8A8_SEEDS = (21, 22, 23, 24)
SAMPLING = SamplingParams(temperature=0.9, top_p=0.9, top_k=20, seed=3)


def fake_mesh(tensor, tensor_rank=0, data=1, data_rank=0):
    """A Mesh with no process groups: enough for the rules, which read only
    the sizes and ranks."""
    return pmesh.Mesh(tensor=tensor, data=data, rank=data_rank * tensor + tensor_rank, tensor_rank=tensor_rank,
                      data_rank=data_rank, tensor_group=None, data_group=None, tensor_src=data_rank * tensor,
                      backend="gloo", device=torch.device("cpu"))


def job(fn, *args, **kwargs):
    return (fn, args, kwargs)


_jax_engines = {}


def jax_engine(jp, jcfg, jduo, B, mesh_shape=None, kv_quant="none"):
    """JAX's engine (kept: its compiled steps serve every prompt of a test),
    unsharded or on a (data, tensor) mesh of the virtual devices (params
    sharded by its shard_params)."""
    key = (id(jp), jcfg, jduo, B, mesh_shape, kv_quant)
    if key not in _jax_engines:
        kw = {}
        if mesh_shape is not None:
            mesh = j_build_mesh(mesh_shape[0] * mesh_shape[1], data=mesh_shape[0])
            jp, kw = j_shard_params(mesh, jcfg, jp), dict(mesh=mesh)
        _jax_engines[key] = JDuoEngine(jp, jcfg, jduo, batch_size=B, dtype=jnp.float32, attn_impl="ref",
                                       kv_quant=kv_quant, **kw)
    return _jax_engines[key]


def jax_tokens(jp, jcfg, jduo, prompt, n, mesh_shape=None, kv_quant="none"):
    eng = jax_engine(jp, jcfg, jduo, prompt.shape[0], mesh_shape, kv_quant)
    return np.asarray(eng.generate(prompt, max_new_tokens=n)[0])


# ---------------------------------------------------------------------------
# Mesh A: data 2 x tensor 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gqa():
    tcfg, jcfg, tp, jp = models("tiny-gqa", 5)
    return tcfg, jcfg, tp, jp


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def mesh_a(gqa, tmp_path_factory):
    """One spawn of 4 ranks (data 2 x tensor 2) running the jobs of the
    generation, mixed-divisibility, W8A8 and serving tests."""
    tcfg, _, tp, _ = gqa
    tduo, _ = duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    mixed, _ = duos(tcfg, (2, 1, 3), sink=8, recent=16, chunk=32, max_size=256)
    _, _, wp, _ = w8a8_models("tiny-gqa", 5)
    jobs = [job(pmesh.generate_job, tp, tcfg, tduo, _prompt(tcfg, 2, 50, 0), 5, dtype=torch.float32),
            job(pmesh.generate_job, tp, tcfg, mixed, _prompt(tcfg, 1, 40, 1), 4, dtype=torch.float32)]
    jobs += [job(pmesh.generate_job, wp, tcfg, tduo, _prompt(tcfg, 1, 40, s), 5, dtype=torch.float32,
                 kv_quant="int4") for s in W8A8_SEEDS]
    serve_prompts = [_prompt(tcfg, 1, n, 7 + i)[0] for i, n in enumerate((17, 50, 33))]
    jobs.append(job(pmesh.serve_job, tp, tcfg, mixed, serve_prompts, 6, max_batch_size=2, dtype=torch.float32))
    jobs.append(job(pmesh.generate_job, tp, tcfg, tduo, _prompt(tcfg, 4, 40, 2), 7, sampling=SAMPLING,
                    dtype=torch.float32, decode_burst=3))
    stops = _split_stops(tp, tcfg, tduo)
    jobs.append(job(pmesh.generate_job, tp, tcfg, tduo, _prompt(tcfg, 4, 40, 2), STOP_NEW, sampling=SAMPLING,
                    stop_token_ids=stops, dtype=torch.float32, decode_burst=3))
    t0 = time.perf_counter()
    out = pmesh.run_ranks(pmesh.run_jobs, 2, 2, args=(jobs,), device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                          store_dir=str(tmp_path_factory.mktemp("store_a")))
    return dict(ranks=out, seconds=time.perf_counter() - t0, serve_prompts=serve_prompts, duo=tduo, mixed=mixed,
                stops=stops)


STOP_NEW = 9  # three bursts of 3


def _split_stops(tp, tcfg, tduo):
    """Stop ids for the sampled B = 4 run of mesh A that end data group 0's
    rows (0 and 1) in the first burst and group 1's (2 and 3) in the second:
    the second token of rows 0 and 1 and the fifth of rows 2 and 3 of the
    one-device run."""
    one = DuoEngine(tp, tcfg, tduo, batch_size=4, dtype=torch.float32, device="cpu", decode_burst=3)
    tokens = one.generate(_prompt(tcfg, 4, 40, 2), STOP_NEW, sampling=SAMPLING)[0]
    return [int(tokens[0, 1]), int(tokens[1, 1]), int(tokens[2, 4]), int(tokens[3, 4])]


def test_every_rank_returns_the_same(mesh_a):
    """Every rank holds the whole batch's tokens and the same served streams."""
    first = mesh_a["ranks"][0]
    for other in mesh_a["ranks"][1:]:
        for a, b in zip(first, other):
            if isinstance(a, dict) and "tokens" in a:
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
            elif isinstance(a, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)


def test_sharded_generate_matches_jax_tp_and_unsharded(gqa, mesh_a):
    """test_spmd.py::test_sharded_pallas_generate_matches_ref: B=2 over data
    2, heads over tensor 2; the port's tokens equal JAX's unsharded tokens
    and JAX's on its own (data 2, tensor 2) mesh."""
    tcfg, jcfg, _, jp = gqa
    _, jduo = duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    prompt = _prompt(tcfg, 2, 50, 0)
    got = mesh_a["ranks"][0][0]["tokens"]
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 5))
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 5, mesh_shape=(2, 2)))


def test_collectives_of_one_decode_step(gqa, mesh_a):
    """One decode step calls what parallel.mesh.collectives_per_step
    reckons: an all_reduce after wo in each of the 3 head-sharded layers and
    after each MLP, one each for the embedding and the head, the token's
    broadcast (the batch split over data needs no gather in a step)."""
    tcfg = gqa[0]
    want = pmesh.collectives_per_step(fake_mesh(2), tcfg, mesh_a["duo"], w8a8=False)
    assert want == {"all_reduce.sum": 3 + 3 + 2, "all_reduce.max": 0, "broadcast": 1}
    for rank in mesh_a["ranks"]:
        assert rank[0]["collectives_per_step"] == want
    # mixed divisibility: layers 1 and 2 (1 and 3 full heads of 4) are replicated
    want_mixed = pmesh.collectives_per_step(fake_mesh(2), tcfg, mesh_a["mixed"], w8a8=False)
    assert want_mixed == {"all_reduce.sum": 1 + 3 + 2, "all_reduce.max": 0, "broadcast": 1}
    assert mesh_a["ranks"][0][1]["collectives_per_step"] == want_mixed
    # W8A8: each row-split product adds an all_reduce MAX of its activation scale
    w8 = pmesh.collectives_per_step(fake_mesh(2), tcfg, mesh_a["duo"], w8a8=True)
    assert w8 == {"all_reduce.sum": 8, "all_reduce.max": 6, "broadcast": 1}
    assert mesh_a["ranks"][0][2]["collectives_per_step"] == w8


def test_sharded_mixed_divisibility(gqa, mesh_a):
    """test_spmd.py::test_sharded_pallas_mixed_divisibility: full heads
    (2, 1, 3) at tensor 2, the layers that do not divide replicated."""
    tcfg, jcfg, _, jp = gqa
    _, jduo = duos(tcfg, (2, 1, 3), sink=8, recent=16, chunk=32, max_size=256)
    prompt = _prompt(tcfg, 1, 40, 1)
    got = mesh_a["ranks"][0][1]["tokens"]
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 4))
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 4, mesh_shape=(1, 2)))


def test_w8a8_tp_matches_jax_under_flip_bounds(mesh_a):
    """test_spmd.py::test_w8a8_tp_matches_unsharded: the W8A8 format with
    the INT4 cache and int8 embedding and head, heads and MLP split over
    tensor 2 (wo and w_down row-split with the activation scale all_reduced,
    float32 partial sums). W8A8 parity is chaotic (tests/test_torch_quant.py):
    against JAX unsharded and JAX on a (data 2, tensor 2) mesh, every stream
    is equal or departs where the port's own unsharded logits hold JAX's
    token within FLIP_LOGIT_GAP of the best, and at least 3 of 4 are equal;
    the prefill's last-token logits are within the flip bound on every
    input and agree with JAX's to TIGHT_ATOL on at least one."""
    tcfg, jcfg, _, jp = w8a8_models("tiny-gqa", 5)
    _, jduo = duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    ranks = mesh_a["ranks"][0]
    tight = equal = 0
    for i, seed in enumerate(W8A8_SEEDS):
        prompt = _prompt(tcfg, 1, 40, seed)
        got, tp_logits = ranks[2 + i]["tokens"], ranks[2 + i]["logits"]
        for mesh_shape in (None, (2, 2)):
            want = jax_tokens(jp, jcfg, jduo, prompt, 5, mesh_shape=mesh_shape, kv_quant="int4")
            steps = np.nonzero(got[0] != want[0])[0]
            if len(steps):  # the TP run's own logits there (fed JAX's tokens so far) hold JAX's token near the top
                t = int(steps[0])
                assert float(tp_logits[t, 0].max() - tp_logits[t, 0, want[0, t]]) <= FLIP_LOGIT_GAP
            equal += mesh_shape is None and not len(steps)
        # the prefill's last-token logits, against JAX unsharded
        _, jl = jax_engine(jp, jcfg, jduo, 1, kv_quant="int4").prefill(prompt)
        tl = tp_logits[0]
        assert rel_fro(tl, np.asarray(jl)) <= FLIP_REL_FRO
        tight += float(np.abs(tl - np.asarray(jl)).max()) <= TIGHT_ATOL
    assert tight >= 1
    assert equal >= 3


def test_serving_tp_matches_isolated(gqa, mesh_a):
    """test_serving.py::test_serving_tp_matches_isolated: a 2-slot pool (one
    slot a data group, KV heads over tensor 2; full heads (2, 1, 3)) serves
    each request the tokens of its isolated one-device run, the port's and
    JAX's."""
    tcfg, jcfg, tp, jp = gqa
    _, jduo = duos(tcfg, (2, 1, 3), sink=8, recent=16, chunk=32, max_size=256)
    served = mesh_a["ranks"][0][6]
    one = DuoEngine(tp, tcfg, mesh_a["mixed"], dtype=torch.float32, device="cpu")
    for i, p in enumerate(mesh_a["serve_prompts"]):
        iso = one.generate(p[None], max_new_tokens=6)[0][0].tolist()
        assert served[i] == iso, f"request {i}"
        assert served[i] == jax_tokens(jp, jcfg, jduo, p[None], 6)[0].tolist(), f"request {i} against JAX"


def test_sampled_generate_over_a_split_batch(gqa, mesh_a):
    """B = 4 split over data 2 (two rows a group), sampled at temperature
    0.9, top-p 0.9, top-k 20 in bursts of 3: each group gathers the batch's
    logits a step and keeps its rows of the whole batch's draw, so the
    tokens are the one-device engine's for the same seed (which are JAX's:
    tests/test_torch_sampling.py)."""
    tcfg, _, tp, _ = gqa
    tduo, _ = duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    got = mesh_a["ranks"][0][7]["tokens"]
    one = DuoEngine(tp, tcfg, tduo, batch_size=4, dtype=torch.float32, device="cpu", decode_burst=3)
    np.testing.assert_array_equal(got, one.generate(_prompt(tcfg, 4, 40, 2), 7, sampling=SAMPLING)[0])


def test_stop_tokens_over_a_split_batch(gqa, mesh_a):
    """B = 4 split over data 2, sampled, with stop ids that end one data
    group's rows a burst before the other's: every group decodes until the
    whole batch has stopped (the groups' collectives stay paired), and the
    tokens, padded after the stops, are the one-device engine's."""
    tcfg, _, tp, _ = gqa
    tduo, stops = mesh_a["duo"], mesh_a["stops"]
    one = DuoEngine(tp, tcfg, tduo, batch_size=4, dtype=torch.float32, device="cpu", decode_burst=3)
    prompt = _prompt(tcfg, 4, 40, 2)
    free = one.generate(prompt, STOP_NEW, sampling=SAMPLING)[0]
    stopped = np.isin(free, stops)
    # the case this checks: group 0 stops in the first burst, group 1 only in the second
    assert stopped[:2, :3].any(axis=1).all() and not stopped[2:, :3].any()
    assert stopped[2:, 3:6].any(axis=1).all()
    want = one.generate(prompt, STOP_NEW, sampling=SAMPLING, stop_token_ids=stops)[0]
    assert (want[:, -3:] == stops[0]).all()  # every row stopped within two bursts
    for rank in mesh_a["ranks"]:
        np.testing.assert_array_equal(rank[8]["tokens"], want)


def test_one_spawn_stays_cheap(mesh_a):
    """The four ranks and every job of mesh A finish well inside the
    spawn's limit."""
    assert mesh_a["seconds"] < SPAWN_TIMEOUT_S / 2


# ---------------------------------------------------------------------------
# Mesh B: tensor 4
# ---------------------------------------------------------------------------

_MOE = dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)
LONG_CFG = dict(vocab_size=256, hidden_size=1024, intermediate_size=1536, num_layers=2, num_heads=8,
                num_kv_heads=8, head_dim=128, model_type="llama")
LONG_CTX = 131072


@pytest.fixture(scope="module")
def mesh_b(tmp_path_factory):
    """One spawn of 4 ranks (tensor 4): expert parallelism and the
    131,072-token INT4 decode."""
    from duo_attention_tpu_torch.config import DuoConfig, ModelConfig

    tcfg, jcfg, tp, jp = models("tiny-gqa", 7, port=_MOE, jax=_MOE)
    tduo, jduo = duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    prompt = _prompt(tcfg, 2, 40, 1)
    lcfg = ModelConfig(**LONG_CFG)
    lduo = DuoConfig(sink_size=64, recent_size=256, num_full_kv_heads=(4, 4), max_cache_size=LONG_CTX,
                     prefill_chunk_size=512)
    lparams = init_params(lcfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = np.zeros(2, np.int64)
    jobs = [job(pmesh.generate_job, tp, tcfg, tduo, prompt, 4, dtype=torch.float32),
            job(pmesh.decode_logits_job, lparams, lcfg, lduo, tokens, LONG_CTX - 576, kv_quant="int4")]
    out = pmesh.run_ranks(pmesh.run_jobs, 4, 1, args=(jobs,), device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                          store_dir=str(tmp_path_factory.mktemp("store_b")))
    return dict(ranks=out, moe=(tcfg, jcfg, jp, jduo, prompt), long=(lparams, lcfg, lduo, tokens))


def test_expert_parallel_moe_matches_jax(mesh_b):
    """test_spmd.py::test_expert_parallel_moe_matches_unsharded: 4 experts
    over tensor 4 (one a rank; the attention's 2 + 2 heads do not divide 4,
    so it is replicated), the dense-dispatch sum all_reduced: the tokens
    equal JAX's unsharded ones and JAX's on its (data 2, tensor 4) mesh."""
    tcfg, jcfg, jp, jduo, prompt = mesh_b["moe"]
    plan = pmesh.plan_for(fake_mesh(4, 1), tcfg, duos(tcfg, (2, 2, 2), sink=8, recent=16, chunk=32,
                                                       max_size=256)[0])
    assert all(s.mlp and not s.sharded for s in plan.layers)
    got = mesh_b["ranks"][0][0]["tokens"]
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 4))
    np.testing.assert_array_equal(got, jax_tokens(jp, jcfg, jduo, prompt, 4, mesh_shape=(2, 4)))


def test_long_context_sharded_q4_decode(mesh_b):
    """test_spmd.py::test_long_context_sharded_q4_decode: one decode step
    against a 131,072-token INT4 cache, one full and one streaming KV head a
    rank: the logits are finite, the length advances, and they equal the
    one-device step's (float32; the wo and MLP sums taken in another
    order)."""
    lparams, lcfg, lduo, tokens = mesh_b["long"]
    from duo_attention_tpu_torch.models import llama

    cache = tcache.init_cache_q4(lcfg, lduo, 2, torch.float32, "cpu")
    cache.length.fill_(LONG_CTX - 576)
    with torch.no_grad():
        hidden, cache = llama.forward_chunk(lparams, lcfg, lduo, cache, torch.as_tensor(tokens)[:, None], 1)
        want = llama.logits_at(lparams, hidden, 0).numpy()
    got = mesh_b["ranks"][0][1]
    assert got.shape == (2, lcfg.vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The dry runs, and a rank that fails
# ---------------------------------------------------------------------------


def test_dryrun_step_on_four_ranks(tmp_path):
    """parallel.mesh.dryrun_step(4): the tp x dp chunk step and the
    expert-parallel step (float32 logits within 1e-4 of one device), 16
    greedy tokens, the trained-pattern NIAH cell and the sharded
    ServingEngine, all equal to one device, on a (data 2, tensor 2) mesh;
    then JAX's pipeline step (2 stages, the one-device tokens) and its
    gate-training step on the same ranks as a (data 2, seq 2) mesh."""
    out = pmesh.dryrun_step(4, device="cpu", timeout_s=SPAWN_TIMEOUT_S, store_dir=str(tmp_path))
    assert set(out) == {"step", "tp_equivalence", "tp_niah_cell", "serving_tp", "pipeline", "train"}
    assert out["tp_equivalence"]["agree"] == 16 and out["pipeline"]["agree"] == 2
    assert np.isfinite(out["train"]["loss"])
    assert out["tp_niah_cell"]["word_overlap"] == 1.0
    assert pmesh.dryrun_tp_niah_cell(1, device="cpu") is None and pmesh.dryrun_serving_tp(2, device="cpu") is None


def _dryrun_1m_at(ctx, tmp_path):
    out = pmesh.dryrun_1m_decode(4, ctx=ctx, device="cpu", timeout_s=SPAWN_TIMEOUT_S, store_dir=str(tmp_path))
    want = pmesh.one_process_1m_logits(ctx, device="cpu")
    assert out["logits"].shape == (1, 512) and np.isfinite(out["logits"]).all()
    np.testing.assert_allclose(out["logits"], want, atol=1e-4, rtol=1e-4)
    # 1 full and 1 streaming head a layer on each of 4 ranks: INT4 K and V of ctx slots and their scales
    assert out["kv_bytes"] == out["kv_bytes_reckoned"] and len(set(out["kv_bytes"])) == 1
    assert out["kv_bytes"][0] >= 2 * 2 * (ctx // 2) * (128 + 8)
    return out


def test_dryrun_1m_decode_at_131072(tmp_path):
    """parallel.mesh.dryrun_1m_decode at 131,072 slots (the 1M geometry with
    a shorter span; tests/test_spmd.py runs 131,072 in tier-1 too): TP = 4,
    W8A8 with int8 embeddings, an INT4 cache of length ctx - 8, one decode
    step with the bucket at ctx: finite logits within 1e-4 of the one-process
    step, and every rank's KV bytes equal to their reckoning."""
    _dryrun_1m_at(131072, tmp_path)


@pytest.mark.slow
def test_dryrun_1m_decode(tmp_path):
    """The true 1,048,576-slot cache (JAX marks its 1M case slow,
    tests/test_spmd.py:131; run with ``-m slow``)."""
    _dryrun_1m_at(1 << 20, tmp_path)


def test_a_failing_rank_fails_the_run(tmp_path):
    """A rank that raises fails run_ranks with its traceback; a rank that
    hangs is killed at the time limit (TimeoutError). Neither leaves a
    process behind."""
    with pytest.raises(RuntimeError, match="tensor 3 x data 1 != 2 ranks"):
        pmesh.run_ranks(pmesh.run_jobs, 2, args=([(pmesh.build_mesh, (3,), {}, False)],), device="cpu", timeout_s=60,
                        store_dir=str(tmp_path))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        pmesh.run_ranks(pmesh.run_jobs, 1, args=([(time.sleep, (120,), {}, False)],), device="cpu",
                        timeout_s=5, store_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 60
    import multiprocessing

    assert not multiprocessing.active_children()


def test_no_card_no_cpu_fallback(tmp_path, monkeypatch):
    """With no GPU present the mesh's entry points on the card raise rather
    than run on the CPU: init_distributed, run_ranks and build_mesh (whose
    default device is the card); the CPU is taken only when asked for."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed("file://" + str(tmp_path / "a"), 1, 0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.run_ranks(pmesh.run_jobs, 1, args=([],), device="cuda", timeout_s=30, store_dir=str(tmp_path))
    pmesh.init_distributed("file://" + str(tmp_path / "b"), 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.build_mesh(1)
        mesh = pmesh.build_mesh(1, device="cpu")
        assert mesh.device == torch.device("cpu") and not mesh.capturable
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The rules, with no process
# ---------------------------------------------------------------------------


def _owned(n, tp, r, base=0):
    return list(range(base + r * n // tp, base + (r + 1) * n // tp))


def _expected_kv(nf, Hkv, tp, r):
    """The head plan: rank r owns full heads [r hf/tp, (r+1) hf/tp) and
    streaming heads hf + [r hs/tp, (r+1) hs/tp) when both divide; else all."""
    hs = Hkv - nf
    if nf % tp or hs % tp:
        return list(range(Hkv)), False
    return _owned(nf, tp, r) + _owned(hs, tp, r, nf), True


def _rows(kv, width):
    return [k * width + d for k in kv for d in range(width)]


@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "moe"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_slices_reassemble_the_full_dict(fmt, tp):
    """shard_params on every rank: each projection's rows (wq, wk, wv, their
    scales and biases; w_gate, w_up) or columns (wo, w_down) are exactly the
    full tensor's at the rank's index list, the experts its expert range,
    the vocab tables its vocab range; the rows and columns of all ranks
    together reassemble the full tensor; what a rule leaves whole is the
    same tensor."""
    from duo_attention_tpu_torch.config import DuoConfig, ModelConfig

    shape = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=3, num_heads=8, num_kv_heads=4,
                 head_dim=8, model_type="mistral", attention_bias=fmt == "bf16")
    cfg = ModelConfig(**{**shape, **(_MOE if fmt == "moe" else {})})
    duo = DuoConfig(sink_size=4, recent_size=8, num_full_kv_heads=(2, 1, 4), max_cache_size=128,
                    prefill_chunk_size=16)
    if fmt == "w8a8":
        params = quant.init_params_w8a8(cfg, seed=1, dtype=torch.float32, device="cpu", quantize_embeds=True)
    else:
        params = init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    G, D = cfg.num_kv_groups, cfg.head_dim
    locals_ = [pmesh.shard_params(fake_mesh(tp, r), cfg, duo, params) for r in range(tp)]
    for li, full in enumerate(params["layers"]):
        for key, t in full.items():
            base = key.removesuffix("_q8").removesuffix("_scale")
            parts = []
            for r, local in enumerate(locals_):
                kv, sharded = _expected_kv(duo.num_full_kv_heads[li], cfg.num_kv_heads, tp, r)
                q_rows = [h * D + d for k in kv for h in range(k * G, (k + 1) * G) for d in range(D)]
                got = local["layers"][li][key]
                if base in ("wq", "bq"):
                    idx, dim = q_rows, 0
                elif base in ("wk", "wv", "bk", "bv"):
                    idx, dim = _rows(kv, D), 0
                elif base == "wo" and not key.endswith("_scale"):
                    idx, dim = q_rows, 1
                elif base in ("w_gate", "w_up") or key.startswith("experts_w"):
                    idx, dim = _owned(t.shape[0], tp, r), 0
                elif base == "w_down" and not key.endswith("_scale"):
                    idx, dim = _owned(t.shape[1], tp, r), 1
                else:
                    assert got is t, key
                    continue
                torch.testing.assert_close(got, t.index_select(dim, torch.tensor(idx)), rtol=0, atol=0)
                parts.append((sharded or base not in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"), idx, dim))
            if parts and all(p[0] for p in parts):  # split: the ranks' indices cover the tensor once
                assert sorted(i for p in parts for i in p[1]) == list(range(t.shape[parts[0][2]])), key
    for key in ("embed", "embed_q8", "embed_scale", "lm_head", "lm_head_q8", "lm_head_scale"):
        if key in params:
            rebuilt = torch.cat([local[key] for local in locals_])
            torch.testing.assert_close(rebuilt, params[key], rtol=0, atol=0)
    assert all(local["final_norm"] is params["final_norm"] for local in locals_)


def test_head_plan_of_the_8b_pattern():
    """artifacts/niah_8b/pattern at sparsity 0.5 on the 8B geometry at tp 2:
    18 of the 32 layers split their heads (hf and 8 - hf both even), 14 are
    replicated; the MLP (14,336) and the vocab (128,256) split."""
    from duo_attention_tpu_torch import PRESETS, DuoConfig

    heads, sink, recent = load_attn_pattern(str(REPO / "artifacts" / "niah_8b" / "pattern"))
    nf = num_full_kv_heads_per_layer(sparsify_attention_heads(heads, sparsity=0.5)[0])
    cfg = PRESETS["Llama-3-8B-Instruct-Gradient-1048k"]
    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=nf, max_cache_size=32768,
                    prefill_chunk_size=4096)
    for r in range(2):
        plan = pmesh.plan_for(fake_mesh(2, r), cfg, duo)
        assert sum(s.sharded for s in plan.layers) == 18
        assert all(s.mlp for s in plan.layers) and plan.vocab and plan.vocab_rows == 128256 // 2
        for s, hf in zip(plan.layers, nf):
            assert (s.hf, s.hs) == ((hf // 2, (8 - hf) // 2) if s.sharded else (hf, 8 - hf))
            assert s.sharded == (hf % 2 == 0)
    bf16 = pmesh.collectives_per_step(fake_mesh(2), cfg, duo, w8a8=False)
    assert bf16 == {"all_reduce.sum": 18 + 32 + 2, "all_reduce.max": 0, "broadcast": 1}


@pytest.mark.parametrize("q4", [False, True])
def test_local_cache_shapes_and_bytes(q4):
    """A rank's cache (cache_shardings' heads and batch rows) has the shape
    shard_cache gives a full cache, and the ranks' KV bytes add up to the
    full cache's on the head-sharded layers and to tp copies on the
    replicated ones."""
    cfg, _, _, _ = models("tiny-gqa", 1)
    duo, _ = duos(cfg, (2, 1, 4), sink=8, recent=16, chunk=32, max_size=256)
    init = tcache.init_cache_q4 if q4 else tcache.init_cache
    full = init(cfg, duo, 4, torch.float32, "cpu")
    total = 0
    for d in range(2):
        for r in range(2):
            mesh = fake_mesh(2, r, data=2, data_rank=d)
            shards = pmesh.cache_shardings(mesh, cfg, duo, 4)
            assert (shards.batch, shards.batch_start) == (2, 2 * d)
            assert shards.heads == ((1, 1), (1, 3), (2, 0))
            local = init(cfg, duo, shards.batch, torch.float32, "cpu", heads=shards.heads)
            sliced = pmesh.shard_cache(mesh, cfg, duo, full)
            for name in full.BUFFERS:
                assert [t.shape for t in getattr(local, name)] == [t.shape for t in getattr(sliced, name)], name
            total += tcache.kv_memory_bytes(local)
    per_layer = [sum(getattr(full, n)[li].numel() * getattr(full, n)[li].element_size() for n in full.BUFFERS)
                 for li in range(cfg.num_layers)]
    # layers 0 and 2 split (data halves the rows too); layer 1 replicated over tensor
    assert total == per_layer[0] + 2 * per_layer[1] + per_layer[2]


def test_the_collectives_are_counted():
    """The collectives' counters ride with the kernels' (a replayed step
    adds them too) under names starting with launches.COLLECTIVE."""
    names = [n for n in launches.counters() if n.startswith(launches.COLLECTIVE)]
    assert names == ["collective.all_reduce.sum", "collective.all_reduce.max", "collective.broadcast"]


def test_check_sharded_refuses_full_params():
    """An engine on a mesh refuses params that are not the rank's slices
    (at tensor 1 the full params are the rank's)."""
    cfg, _, tp, _ = models("tiny-gqa", 2)
    duo, _ = duos(cfg, (2, 2, 2), sink=8, recent=16, chunk=32, max_size=256)
    assert pmesh.check_sharded(fake_mesh(1), cfg, duo, tp) is None
    with pytest.raises(ValueError, match="shard_params"):
        pmesh.check_sharded(fake_mesh(2), cfg, duo, tp)
    with pytest.raises(ValueError, match="shard_params"):
        DuoEngine(tp, cfg, duo, device="cpu", mesh=fake_mesh(2))
