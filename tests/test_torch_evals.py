"""The port's eval stack on the CPU, against the JAX package's.

Counterparts of tests/test_evals.py, test_graft_8b.py and the engine parts of
test_accuracy_loop.py: ``single_bucket`` decoding, the NIAH harness (prompt
ids; responses and scores of the constructed circuit in generate and
simulation modes), ``eval_retrieval`` of the 8B graft's CPU-sized twin
(SMALL_D128_SPEC) in float32 and W8A8KV4, the LongBench data generator
(against the tracked records), ``predict_task`` and ``score_file``, the
efficiency functions, the synthetic checkpoint writer, the demo and the CLIs.

Tokens, response strings, scores and written files must be equal to JAX's
(the circuit's score margins are tens of nats, far above the float32
differences between the two packages' attention). The retrieval thresholds
are test_graft_8b.py's for JAX: word overlap 1.0 with the trained pattern,
below 0.25 with the inverted one, over 4 samples.
"""

import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu import cache as jcache
from duo_attention_tpu import engine as jengine
from duo_attention_tpu.config import DuoConfig as JDuoConfig
from duo_attention_tpu.evals import longbench as jlongbench
from duo_attention_tpu.evals import niah as jniah
from duo_attention_tpu.models import constructed as jc
from duo_attention_tpu.models import convert as jconvert
from duo_attention_tpu.models import synth as jsynth
from duo_attention_tpu.tokenizer import get_tokenizer as jget_tokenizer
from duo_attention_tpu_torch import cache as tcache
from duo_attention_tpu_torch import DuoConfig, DuoEngine, demo
from duo_attention_tpu_torch.config import PRESETS
from duo_attention_tpu_torch.evals import efficiency, longbench, longbench_data, niah
from duo_attention_tpu_torch.evals.accuracy_loop import build_engine, eval_retrieval
from duo_attention_tpu_torch.models import constructed as tc
from duo_attention_tpu_torch.models import synth
from duo_attention_tpu_torch.models.convert import reorder_params
from duo_attention_tpu_torch.tokenizer import get_tokenizer
from duo_attention_tpu_torch.train.data import _CODE_WORDS, _NAMES, MultiPasskeyDataset, PasskeyDataConfig
from test_torch_model import duos, models

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
NEEDLE = dict(needle=f" Remember this: the secret code of {_NAMES[7]} is {' '.join(_CODE_WORDS[9:12])}. ",
              question=f"\nQuestion: the secret code of {_NAMES[7]} is", answer=" ".join(_CODE_WORDS[9:12]))


def circuit_engines(max_cache=1024, chunk=128, single_bucket=False):
    """(port engine, JAX engine) on the BASE circuit with its ground-truth
    retrieval heads (reordered first), float32, sink 16, recent 64."""
    spec = tc.BASE_SPEC
    cfg, jcfg = spec.model_config(), jc.BASE_SPEC.model_config()
    heads = tc.ground_truth_heads(spec)
    tparams, nf = reorder_params(tc.build_params(get_tokenizer("word"), device="cpu"), cfg, heads)
    jparams, jnf = jconvert.reorder_params(jc.build_params(jget_tokenizer("word")), jcfg, heads)
    kw = dict(sink_size=16, recent_size=64, max_cache_size=max_cache, prefill_chunk_size=chunk)
    teng = DuoEngine(tparams, cfg, DuoConfig(num_full_kv_heads=nf, **kw), dtype=torch.float32, device="cpu",
                     single_bucket=single_bucket)
    jeng = jengine.DuoEngine(jparams, jcfg, JDuoConfig(num_full_kv_heads=tuple(jnf), **kw), dtype=jnp.float32,
                             attn_impl="ref", single_bucket=single_bucket)
    return teng, jeng


@pytest.fixture(scope="module")
def engines():
    return circuit_engines()


def test_single_bucket_engine_matches_bucketed_and_jax():
    """single_bucket=True generates the geometric-bucket engine's tokens and
    the JAX engine's (test_graft_8b.py::test_single_bucket_engine_matches_bucketed)."""
    tcfg, jcfg, tp, jp = models("tiny-gqa", 0)
    tduo, jduo = duos(tcfg, (2, 1, 3), sink=8, recent=16, chunk=32, max_size=2048)
    prompt = np.random.default_rng(0).integers(0, 512, (1, 600)).astype(np.int32)
    e1 = DuoEngine(tp, tcfg, tduo, dtype=torch.float32, device="cpu")
    e2 = DuoEngine(tp, tcfg, tduo, dtype=torch.float32, device="cpu", single_bucket=True)
    assert (e1.bucket_for(300), e1.bucket_for(600)) == (512, 1024)
    assert e2.bucket_for(1) == e2.bucket_for(600) == 2048
    t1, c1 = e1.generate(prompt, 8)
    t2, c2 = e2.generate(prompt, 8)
    je = jengine.DuoEngine(jp, jcfg, jduo, dtype=jnp.float32, attn_impl="ref", single_bucket=True)
    tj, cj = je.generate(prompt, 8)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t2, np.asarray(tj))
    assert int(c1.length) == int(c2.length) == int(cj.length) == 608


@pytest.mark.parametrize("kind", ["word", "byte"])
def test_niah_prompt_ids_equal(kind, tmp_path):
    over = NEEDLE if kind == "word" else {}
    tt = niah.NIAHTester(None, get_tokenizer(kind), niah.NIAHConfig(output_dir=str(tmp_path / "t"), **over))
    jt = jniah.NIAHTester(None, jget_tokenizer(kind), jniah.NIAHConfig(output_dir=str(tmp_path / "j"), **over))
    for ctx in (448, 1000):
        for depth in (0.0, 37.5, 100.0):
            ids = tt.build_prompt_ids(ctx, depth)
            assert ids == jt.build_prompt_ids(ctx, depth)
            assert len(ids) <= ctx and ids[0] == 1 and 1 not in ids[1:]


@pytest.mark.parametrize("sim", [0, 16])
def test_niah_constructed_matches_jax(engines, sim, tmp_path):
    """ctx 448 at depths 0/50/100: the circuit retrieves in both modes, and
    every cell's response and scores are JAX's."""
    teng, jeng = engines
    common = dict(context_lengths=[448], depth_percents=[0.0, 50.0, 100.0], gen_tokens=8,
                  simulation_tokens=sim, resume=False, **NEEDLE)
    got = niah.NIAHTester(teng, get_tokenizer("word"), niah.NIAHConfig(output_dir=str(tmp_path / "t"),
                                                                       **common)).run()
    want = jniah.NIAHTester(jeng, jget_tokenizer("word"), jniah.NIAHConfig(output_dir=str(tmp_path / "j"),
                                                                           **common)).run()
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "latency_s"} == {k: v for k, v in w.items() if k != "latency_s"}
        assert g["word_overlap"] == 1.0, g
    # resume by existence, then the heatmap
    tester = niah.NIAHTester(teng, get_tokenizer("word"), niah.NIAHConfig(
        output_dir=str(tmp_path / "t"), **dict(common, resume=True)))
    assert [r["response"] for r in tester.run()] == [r["response"] for r in got]
    assert os.path.exists(niah.visualize(str(tmp_path / "t")))


@pytest.fixture(scope="module")
def passkeys():
    dcfg = PasskeyDataConfig(context_length_min=768, context_length_max=1024, num_passkeys=2, passkey_length=3)
    return get_tokenizer("word"), MultiPasskeyDataset(get_tokenizer("word"), dcfg, num_samples=100_000)


@pytest.mark.parametrize("fmt", ["f32", "w8a8kv4"])
@pytest.mark.parametrize("inverted", [False, True])
def test_eval_retrieval_graft_twin(passkeys, fmt, inverted):
    """The 8B graft's twin retrieves with the trained pattern and collapses
    with the inverted one (test_graft_8b.py:65-96): float32, and the W8A8
    build reordered q8-aware with the INT4 cache in bf16, as the 8B runs."""
    tok, ds = passkeys
    spec = tc.SMALL_D128_SPEC
    cfg = spec.model_config()
    gt = tc.ground_truth_heads(spec)
    heads = 1.0 - gt if inverted else gt
    if fmt == "f32":
        eng = build_engine(tc.build_params(tok, spec=spec, device="cpu"), cfg, heads, sink=16, recent=64,
                           max_cache=4096, chunk=512, device="cpu")
    else:
        eng = build_engine(tc.build_params_w8a8(tok, spec=spec, device="cpu"), cfg, heads, sink=16, recent=64,
                           max_cache=4096, chunk=512, dtype=torch.bfloat16, kv_quant="int4", device="cpu")
    r = eval_retrieval(eng, tok, ds, n_samples=4)
    if inverted:
        assert r["word_overlap"] < 0.25, r
    else:
        assert r["word_overlap"] == 1.0 and r["exact_match"] == 1.0, r


@pytest.mark.parametrize("task", sorted(longbench_data.build_tasks()))
def test_longbench_data_reproduces_tracked_files(task):
    recs = longbench_data.build_tasks()[task]
    text = "".join(json.dumps(r) + "\n" for r in recs)
    assert text == (REPO / "artifacts" / "longbench_tpu" / "data" / f"{task}.jsonl").read_text()


def test_longbench_registry_equal():
    assert longbench.TASK_PROMPTS == jlongbench.TASK_PROMPTS
    assert longbench.TASK_MAXGEN == jlongbench.TASK_MAXGEN
    assert longbench.ALL_TASKS == jlongbench.ALL_TASKS and len(longbench.ALL_TASKS) == 21
    assert {t: f.__name__ for t, f in longbench.TASK_METRIC.items()} == \
        {t: f.__name__ for t, f in jlongbench.TASK_METRIC.items()}
    ids = list(range(100))
    assert longbench.truncate_middle(ids, 10) == jlongbench.truncate_middle(ids, 10)


def test_predict_task_and_score_match_jax(tmp_path):
    """Two trec records through the circuit (simulation 16 tokens, stop at
    '.', single bucket): the prediction files and scores are JAX's."""
    teng, jeng = circuit_engines(max_cache=2048, chunk=256, single_bucket=True)
    data = longbench.load_task_data("trec", str(REPO / "artifacts" / "longbench_tpu" / "data"))[:2]
    outs = {}
    for pkg, mod, eng, tok in (("t", longbench, teng, get_tokenizer("word")),
                               ("j", jlongbench, jeng, jget_tokenizer("word"))):
        stop = tuple(mod.encode_ids(tok, ".")[-1:])
        path = str(tmp_path / f"{pkg}_trec.jsonl")
        mod.predict_task(eng, tok, "trec", data, 8000, path, simulation_tokens=16, stop_ids=stop)
        mod.predict_task(eng, tok, "trec", data, 8000, path, simulation_tokens=16, stop_ids=stop)  # resumes
        outs[pkg] = (Path(path).read_text(), mod.score_file("trec", path), mod.score_file_e("trec", path))
    assert outs["t"] == outs["j"]
    assert len(outs["t"][0].splitlines()) == 2 and outs["t"][1] == 100.0, outs["t"]


def _kv_bytes(cfg, duo, batch, kv_quant, decode_only=False):
    """KV bytes reckoned from the DuoConfig: INT4 full heads hold a byte and
    two bf16 scale pairs (scale, zero point) per token pair; bf16 rows 2 bytes
    a channel; the streaming sink and ring in bf16."""
    T, D = duo.max_cache_size, cfg.head_dim
    if decode_only:
        sink, ring = -(-(duo.sink_size + 8) // 8) * 8, -(-(duo.recent_size + 8) // 128) * 128
    else:
        sink, ring = duo.sink_size + duo.prefill_chunk_size, -(-(duo.recent_size + duo.prefill_chunk_size) // 512) * 512
    full_per_head = (T // 2 * D + 4 * (T // 2) * 2) if kv_quant == "int4" else T * D * 2
    total = 0
    for hf in duo.num_full_kv_heads:
        total += 2 * batch * (hf * full_per_head + (cfg.num_kv_heads - hf) * (sink + ring) * D * 2)
    return total


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_efficiency_functions_tiny(kv_quant):
    cfg = PRESETS["tiny-gqa"]
    duo = DuoConfig(sink_size=8, recent_size=16, num_full_kv_heads=(2, 1, 3), max_cache_size=256,
                    prefill_chunk_size=32)
    w8a8 = kv_quant == "int4"
    params = efficiency.make_params(cfg, w8a8, "cpu")
    engine = DuoEngine(params, cfg, duo, device="cpu", kv_quant=kv_quant)
    t, kv = efficiency.bench_prefill(engine, 200, runs=1)
    assert t > 0 and kv == tcache.kv_memory_bytes(engine.new_cache()) == _kv_bytes(cfg, duo, 1, kv_quant)
    t, kv2 = efficiency.bench_decode(engine, 256, steps=4, warmup=2, repeats=2)
    assert t > 0 and kv2 == kv
    agg, kv3 = efficiency.bench_serving(cfg, duo, 2, 256, kv_quant=kv_quant, steps=4, w8a8=w8a8, params=params,
                                        device="cpu")
    assert agg > 0 and kv3 == _kv_bytes(cfg, duo, 2, kv_quant, decode_only=True)
    if kv_quant == "none":  # the JAX cache pads INT4 scales to 8 rows; bf16 bytes are equal
        jduo = JDuoConfig(sink_size=8, recent_size=16, num_full_kv_heads=(2, 1, 3), max_cache_size=256,
                          prefill_chunk_size=32)
        from duo_attention_tpu.config import TINY_GQA

        assert kv == jcache.kv_memory_bytes(jcache.init_cache(TINY_GQA, jduo, 1, jnp.bfloat16))


def test_efficiency_cli_tiny(tmp_path):
    rec = efficiency.main(["--model", "tiny-gqa", "--num-layers", "2", "--ctx-len", "512", "--prefill-chunk",
                           "128", "--decode-steps", "4", "--w8a8", "--kv-quant", "int4", "--serving-batch", "2",
                           "--device", "cpu", "--output", str(tmp_path / "r.txt"),
                           "--json-output", str(tmp_path / "r.jsonl")])
    assert rec["decode_ms_per_step"] > 0 and rec["serving_tok_s"] > 0 and rec["prefill_tok_s"] > 0
    assert json.loads((tmp_path / "r.jsonl").read_text())["kv_bytes"] == rec["kv_bytes"]


@pytest.mark.parametrize("dtype", ["BF16", "F32", "F16"])
def test_synth_checkpoint_bytes_equal(dtype, tmp_path):
    from duo_attention_tpu.config import PRESETS as JPRESETS

    synth.write_synth_checkpoint(str(tmp_path / "t"), PRESETS["tiny-gqa"], seed=3, dtype=dtype)
    jsynth.write_synth_checkpoint(str(tmp_path / "j"), JPRESETS["tiny-gqa"], seed=3, dtype=dtype)
    for name in ("model.safetensors", "config.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("flags", [[], ["--no-w8a8", "--no-int4-kv"]])
def test_demo_runs_tiny(flags):
    text = demo.main(["--model", "tiny-gqa", "--num-layers", "2", "--len", "700", "--prefill-chunk", "256",
                      "--max-new-tokens", "4", "--quantize-embeds", "--device", "cpu", *flags])
    assert isinstance(text, str)


def test_niah_and_longbench_clis_constructed(tmp_path):
    results = niah.main(["--model", "constructed", "--ctx", "448", "--depths", "3", "--sink", "16", "--recent",
                         "64", "--max-cache", "1024", "--prefill-chunk", "128", "--sparsity", "0.75",
                         "--device", "cpu", "--output-dir", str(tmp_path / "niah")])
    assert len(results) == 3 and all(np.isfinite(r["score"]) for r in results)
    data = tmp_path / "data"
    longbench_data.main([str(data)])
    scores = longbench.main(["--model", "constructed", "--tasks", "trec", "--max-samples", "1", "--data-dir",
                             str(data), "--max-prompt-len", "1500", "--max-cache", "2048", "--prefill-chunk", "256",
                             "--simulation-tokens", "4", "--stop-text", ".", "--single-bucket", "--sink", "16",
                             "--recent", "64", "--device", "cpu", "--out-dir", str(tmp_path / "lb")])
    assert set(scores) == {"trec"} and 0.0 <= scores["trec"] <= 100.0


@pytest.mark.parametrize("cli", ["niah", "longbench"])
@pytest.mark.parametrize("flag", ["--pp"])
def test_parallel_flags_name_the_roadmap_item(cli, flag, tmp_path):
    """``--pp 2`` (it raised, naming the roadmap item, until pipeline
    parallelism was ported): two stages on the CPU give the one-device
    CLI's results; JAX's restrictions still raise (generate mode only,
    unquantized)."""
    mod = niah if cli == "niah" else longbench
    if cli == "niah":
        args = ["--model", "constructed", "--ctx", "448", "--depths", "3", "--sink", "16", "--recent", "64",
                "--max-cache", "1024", "--prefill-chunk", "128", "--sparsity", "0.5", "--device", "cpu"]
        one = mod.main(args + ["--output-dir", str(tmp_path / "one")])
        pp = mod.main(args + ["--output-dir", str(tmp_path / "pp"), flag, "2"])
        strip = lambda rs: [{k: v for k, v in r.items() if k != "latency_s"} for r in rs]  # noqa: E731
        assert strip(pp) == strip(one) and len(pp) == 3
    else:
        data = tmp_path / "data"
        longbench_data.main([str(data)])
        args = ["--model", "constructed", "--tasks", "trec", "--max-samples", "2", "--data-dir", str(data),
                "--max-prompt-len", "1500", "--max-cache", "2048", "--prefill-chunk", "256", "--simulation-tokens",
                "0", "--stop-text", ".", "--sink", "16", "--recent", "64", "--device", "cpu"]
        one = mod.main(args + ["--out-dir", str(tmp_path / "one")])
        pp = mod.main(args + ["--out-dir", str(tmp_path / "pp"), flag, "2"])
        assert pp == one and set(pp) == {"trec"}
        assert (tmp_path / "pp" / "trec.jsonl").read_text() == (tmp_path / "one" / "trec.jsonl").read_text()
    for extra in (["--w8a8"], ["--simulation-tokens", "4"]):
        with pytest.raises(SystemExit, match="--pp"):
            mod.main([flag, "2", "--device", "cpu", *extra])


def test_niah_cli_tp_matches_one_device(tmp_path):
    """niah.main(--tp 2) on the constructed circuit (2 full and 2 streaming
    KV heads a layer at sparsity 0.5, each split over the 2 gloo ranks):
    every cell's response and score equal the --tp 0 run's, rank 0 wrote the
    cells, and resuming reads them back on every rank."""
    args = ["--model", "constructed", "--ctx", "448", "--depths", "3", "--sink", "16", "--recent", "64",
            "--max-cache", "1024", "--prefill-chunk", "128", "--sparsity", "0.5", "--device", "cpu"]
    one = niah.main(args + ["--output-dir", str(tmp_path / "one")])
    tp = niah.main(args + ["--output-dir", str(tmp_path / "tp"), "--tp", "2"])
    strip = lambda rs: [{k: v for k, v in r.items() if k != "latency_s"} for r in rs]  # noqa: E731
    assert strip(tp) == strip(one) and len(tp) == 3
    assert sorted(p.name for p in (tmp_path / "tp").iterdir()) == sorted(p.name for p in (tmp_path / "one").iterdir())
    assert niah.main(args + ["--output-dir", str(tmp_path / "tp"), "--tp", "2"]) == tp


def test_longbench_cli_tp_matches_one_device(tmp_path):
    """longbench.main(--tp 2) on the constructed circuit: the trec
    predictions and score equal the --tp 0 run's, written once, by rank 0."""
    data = tmp_path / "data"
    longbench_data.main([str(data)])
    args = ["--model", "constructed", "--tasks", "trec", "--max-samples", "2", "--data-dir", str(data),
            "--max-prompt-len", "1500", "--max-cache", "2048", "--prefill-chunk", "256", "--simulation-tokens", "4",
            "--stop-text", ".", "--single-bucket", "--sink", "16", "--recent", "64", "--device", "cpu"]
    one = longbench.main(args + ["--out-dir", str(tmp_path / "one")])
    tp = longbench.main(args + ["--out-dir", str(tmp_path / "tp"), "--tp", "2"])
    assert tp == one and set(tp) == {"trec"}
    assert (tmp_path / "tp" / "trec.jsonl").read_text() == (tmp_path / "one" / "trec.jsonl").read_text()
