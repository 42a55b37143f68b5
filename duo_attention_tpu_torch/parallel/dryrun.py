"""The TP dry runs and the rank jobs: the engines, serving, the pipeline,
an eval cell and a training step run on spawned ranks (``mesh.run_ranks``)
and held to the one-device path.

Counterpart of the dry runs of duo_attention_tpu/parallel/mesh.py
(``dryrun_step``, ``dryrun_tp_equivalence``, ``dryrun_tp_niah_cell``,
``dryrun_serving_tp``, ``dryrun_1m_decode``). The rank jobs
(``generate_job``, ``serve_job``, ``decode_logits_job``) are what tests and
scripts hand ``mesh.run_jobs`` on spawned ranks: a spawned rank imports its
function's module, so they live in the package, never in a test module. This
module sits above the engines; ``mesh.py``, below the model step, imports
nothing of it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..cache import cache_constructor, init_cache, init_cache_q4, kv_memory_bytes
from ..config import DuoConfig, ModelConfig
from ..engine import DuoEngine
from ..evals.accuracy_loop import _cast_floats
from ..evals.niah import NIAHConfig, NIAHTester
from ..models import llama
from ..models.constructed import BASE_SPEC, build_params
from ..models.convert import reorder_params
from ..ops import launches
from ..ops.quant import init_params_w8a8
from ..patterns import load_attn_pattern, sparsify_attention_heads
from ..serving import Request, ServingEngine
from ..tokenizer import get_tokenizer
from ..train.data import _CODE_WORDS, _NAMES
from ..train.trainer import _dryrun_train_rank
from .mesh import Mesh, cache_shardings, gather_rows, run_ranks, shard_params, sharder
from .pipeline import PipelinedEngine

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


def greedy_gaps(engine, prompt, n: int):
    """An engine's greedy tokens [B, n] from eager decode steps, and the
    top-2 logit gap before each (the smallest over the batch). Under a mesh
    every rank of it calls this, with a batch that is not split."""
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


def agree_until_tie(got, want, gaps, near_tie: float, label: str) -> int:
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
    base_cfg, base_duo, dtype = _dryrun_setup(device)
    cfg, duo = cfg or base_cfg, duo or base_duo
    params = llama.init_params(cfg, seed=2, dtype=dtype, device=device)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 48))
    want, gaps = greedy_gaps(DuoEngine(params, cfg, duo, dtype=dtype, device=device), prompt, 16)
    eng = DuoEngine(shard_params(mesh, cfg, duo, params), cfg, duo, dtype=dtype, device=device, mesh=mesh)
    got, _ = eng.generate(prompt, max_new_tokens=16)
    near_tie = DRYRUN_NEAR_TIE if torch.device(device).type == "cuda" else 0.0
    return {"agree": agree_until_tie(got, want, gaps, near_tie, "tp_equivalence"), "tokens": got.tolist()}


def _dry_tp_niah_cell(mesh: Mesh, device) -> dict:
    """One NIAH cell of the constructed circuit with its trained pattern
    (artifacts/accuracy_loop/pattern, sparsity 0.5): the tp-sharded engine's
    response equals the one-device engine's, and both retrieve the needle
    (JAX ``dryrun_tp_niah_cell``)."""
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
        want, gaps = greedy_gaps(one, p[None], 6)
        agree_until_tie(np.asarray([finished[i]]), want, gaps, near_tie, f"serving_tp request {i}")
    return {"tokens": finished}


def _dry_pipeline(mesh: Mesh, device) -> dict:
    """JAX dryrun_step's pipeline step: 2 balanced layer stages
    (``parallel/pipeline.py``; both on the rank's device) generate the
    one-device engine's tokens from a zero prompt of one chunk (on the card
    up to a near-tie)."""
    cfg, duo, dtype = _dryrun_setup(device)
    params = llama.init_params(cfg, seed=0, dtype=dtype, device=device)
    prompt = np.zeros((1, duo.prefill_chunk_size), np.int64)
    want, gaps = greedy_gaps(DuoEngine(params, cfg, duo, dtype=dtype, device=device), prompt, 2)
    got, caches = PipelinedEngine(params, cfg, duo, devices=[mesh.device] * 2, dtype=dtype).generate(prompt, 2)
    if got.shape != (1, 2) or [int(c.length) for c in caches] != [duo.prefill_chunk_size + 2] * 2:
        raise AssertionError(f"pipeline step: tokens {got.shape}, stage lengths {[int(c.length) for c in caches]}")
    near_tie = DRYRUN_NEAR_TIE if torch.device(device).type == "cuda" else 0.0
    return {"agree": agree_until_tie(got, want, gaps, near_tie, "pipeline"), "tokens": got.tolist()}


def _dry_train(mesh: Mesh, device) -> dict:
    """JAX dryrun_step's training step on the same ranks seen as a (data, seq)
    mesh (``train/trainer.py``'s dry-run model; sp = the tensor size)."""
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
# Rank jobs: what tests and scripts run on spawned ranks (mesh.run_ranks(mesh.run_jobs, ...))
# ---------------------------------------------------------------------------


def stream_logits(engine, prompt, stream) -> np.ndarray:
    """An engine's logits before each token of ``stream`` [B, n] fed after
    ``prompt`` [B, S] (teacher-forced eager steps on a new cache), float32
    [n, B, vocab] of the whole batch. Under a mesh every rank of it calls
    this."""
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
    B = tokens.shape[0]
    shards = cache_shardings(mesh, cfg, duo, B)
    cache = cache_constructor(kv_quant)(cfg, duo, shards.batch, dtype, mesh.device, heads=shards.heads)
    cache.length.fill_(length)
    local = shard_params(mesh, cfg, duo, params)
    rows = torch.as_tensor(tokens, device=mesh.device)[shards.batch_start : shards.batch_start + shards.batch]
    with torch.no_grad():
        hidden, cache = llama.forward_chunk(local, cfg, duo, cache, rows[:, None], 1, mesh=mesh)
        logits = gather_rows(mesh, llama.logits_at(local, hidden, 0, mesh=mesh, cfg=cfg), B)
    if int(cache.length) != length + 1:
        raise AssertionError(f"cache length {int(cache.length)} after a step from {length}")
    return logits.float().cpu().numpy()
