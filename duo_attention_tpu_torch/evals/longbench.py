"""LongBench evaluation: prediction + scoring.

Counterpart of duo_attention_tpu/evals/longbench.py (itself the counterpart
of the reference's eval/LongBench/pred.py, eval.py, metrics.py and
config/*.json): 21 tasks and two synthetic-data ones, middle truncation to
the model budget, optional per-token decoding simulation of the final N
tokens (streaming-cache eviction acts on the state as in deployment), greedy
generation, per-task metrics and LongBench-E length-bucketed scores.

Data: local JSONL files with the LongBench fields (input, context, answers,
all_classes, length), else HF ``datasets`` where it is installed and cached.
The repo's own records are artifacts/longbench_tpu/data/*.jsonl
(``evals/longbench_data.py``). On the card, the constructed 8B-geometry
circuit in W8A8KV4 with the trained pattern:

    python -m duo_attention_tpu_torch.evals.longbench --model constructed-8b \
        --w8a8 --kv-quant int4 --stop-text . --single-bucket \
        --data-dir artifacts/longbench_tpu/data --tasks trec lsht \
        --max-prompt-len 8000 --max-cache 16384 --prefill-chunk 2048 \
        --simulation-tokens 16 --attn-pattern artifacts/niah_8b/pattern \
        --out-dir chiprun_out/longbench/trained

``--tp N`` runs N tensor-parallel ranks as ``evals/niah.py`` does; rank 0
writes the predictions and the scores. ``--pp N`` runs N pipeline stages as
``evals/niah.py`` does (with ``--simulation-tokens 0``, unquantized).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..engine import DuoEngine
from ..tokenizer import decode_ids, encode_ids, get_tokenizer
from . import metrics as M

# --- task registry (LongBench standard prompts/limits) ---------------------

TASK_PROMPTS: Dict[str, str] = {
    "narrativeqa": "You are given a story, which can be either a novel or a movie script, and a question. Answer the question as concisely as you can, using a single phrase if possible.\n\nStory: {context}\n\nQuestion: {input}\n\nAnswer:",
    "qasper": "You are given a scientific article and a question. Answer the question as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write \"unanswerable\".\n\nArticle: {context}\n\nQuestion: {input}\n\nAnswer:",
    "multifieldqa_en": "Read the following text and answer briefly.\n\n{context}\n\nNow, answer the following question based on the above text, only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "multifieldqa_zh": "阅读以下文字并用中文简短回答：\n\n{context}\n\n现在请基于上面的文章回答下面的问题，只告诉我答案，不要输出任何其他字词。\n\n问题：{input}\n回答：",
    "hotpotqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "2wikimqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "musique": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "dureader": "请基于给定的文章回答下述问题。\n\n文章：{context}\n\n问题：{input}\n回答：",
    "gov_report": "You are given a report by a government agency. Write a one-page summary of the report.\n\nReport:\n{context}\n\nNow, write a one-page summary of the report.\n\nSummary:",
    "qmsum": "You are given a meeting transcript and a query containing a question or instruction. Answer the query in one or more sentences.\n\nTranscript:\n{context}\n\nNow, answer the query based on the above meeting transcript in one or more sentences.\n\nQuery: {input}\nAnswer:",
    "multi_news": "You are given several news passages. Write a one-page summary of all news.\n\nNews:\n{context}\n\nNow, write a one-page summary of all the news.\n\nSummary:",
    "vcsum": "下面有一段会议记录，请你阅读后，写一段总结，总结会议的内容。\n会议记录：\n{context}\n\n会议总结：",
    "trec": "Please determine the type of the question below. Here are some examples of questions.\n\n{context}\n{input}",
    "triviaqa": "Answer the question based on the given passage. Only give me the answer and do not output any other words. The following are some examples.\n\n{context}\n\n{input}",
    "samsum": "Summarize the dialogue into a few short sentences. The following are some examples.\n\n{context}\n\n{input}",
    "lsht": "请判断给定新闻的类别，下面是一些例子。\n\n{context}\n{input}",
    "passage_count": "There are some paragraphs below sourced from Wikipedia. Some of them may be duplicates. Please carefully read these paragraphs and determine how many unique paragraphs there are after removing duplicates. In other words, how many non-repeating paragraphs are there in total?\n\n{context}\n\nPlease enter the final count of unique paragraphs after removing duplicates. The output format should only contain the number, such as 1, 2, 3, and so on.\n\nThe final answer is: ",
    "passage_retrieval_en": "Here are 30 paragraphs from Wikipedia, along with an abstract. Please determine which paragraph the abstract is from.\n\n{context}\n\nThe following is an abstract.\n\n{input}\n\nPlease enter the number of the paragraph that the abstract is from. The answer format must be like \"Paragraph 1\", \"Paragraph 2\", etc.\n\nThe answer is: ",
    "passage_retrieval_zh": "以下是若干段落文字，以及其中一个段落的摘要。请确定给定的摘要出自哪一段。\n\n{context}\n\n下面是一个摘要\n\n{input}\n\n请输入摘要所属段落的编号。答案格式必须是\"段落1\"，\"段落2\"等格式\n\n答案是：",
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": "Please complete the code given below. \n{context}{input}Next line of code:\n",
    # Grammar-compatible counterparts of two more official metric
    # families, for synthesized-data runs (scripts/run_longbench_tpu.sh):
    # the official passage_retrieval / lcc / repobench templates append a
    # fixed suffix AFTER {input} ("The answer is: " / "Next line of
    # code:\n"), which no retrieval-only model can see past — the same
    # reason passage_count was dropped from the round-3 artifact. These
    # variants end at bare {input} (like trec/triviaqa/samsum/lsht) but
    # are scored by the OFFICIAL metric implementations
    # (eval/LongBench/eval.py:18-40 semantics: retrieval_score,
    # code_sim_score), so the metric families are exercised end-to-end.
    "passage_retrieval_style": "Here are numbered paragraphs from an archive. Each paragraph states which entry it holds. Please determine which paragraph answers the question.\n\n{context}\n\n{input}",
    "codecomp_style": "Please complete the code given below. The following are some examples.\n\n{context}\n\n{input}",
}

TASK_MAXGEN: Dict[str, int] = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "multifieldqa_zh": 64, "hotpotqa": 32, "2wikimqa": 32, "musique": 32,
    "dureader": 128, "gov_report": 512, "qmsum": 512, "multi_news": 512,
    "vcsum": 512, "trec": 64, "triviaqa": 32, "samsum": 128, "lsht": 64,
    "passage_count": 32, "passage_retrieval_en": 32,
    "passage_retrieval_zh": 32, "lcc": 64, "repobench-p": 64,
    "passage_retrieval_style": 32, "codecomp_style": 64,
}

# task -> scorer, matching the reference task-by-task
# (eval/LongBench/eval.py:18-40): the four zh-text tasks use the
# jieba-segmented scorers (metrics.qa_f1_zh_score etc.); lsht is Chinese
# but classification scoring is language-neutral (substring match).
TASK_METRIC = {
    "narrativeqa": M.qa_f1_score, "qasper": M.qa_f1_score,
    "multifieldqa_en": M.qa_f1_score, "multifieldqa_zh": M.qa_f1_zh_score,
    "hotpotqa": M.qa_f1_score, "2wikimqa": M.qa_f1_score,
    "musique": M.qa_f1_score, "dureader": M.rouge_zh_score,
    "gov_report": M.rouge_score, "qmsum": M.rouge_score,
    "multi_news": M.rouge_score, "vcsum": M.rouge_zh_score,
    "trec": M.classification_score, "triviaqa": M.qa_f1_score,
    "samsum": M.rouge_score, "lsht": M.classification_score,
    "passage_count": M.count_score,
    "passage_retrieval_en": M.retrieval_score,
    "passage_retrieval_zh": M.retrieval_zh_score,
    "lcc": M.code_sim_score, "repobench-p": M.code_sim_score,
    "passage_retrieval_style": M.retrieval_score,
    "codecomp_style": M.code_sim_score,
}

# the 21 OFFICIAL LongBench tasks (the _style variants are synthetic-data
# counterparts, run only by explicit --tasks selection)
ALL_TASKS = [t for t in TASK_PROMPTS if not t.endswith("_style")]


def load_task_data(task: str, data_dir: Optional[str], e_split: bool = False):
    """Local JSONL first; fall back to HF datasets."""
    if data_dir:
        path = os.path.join(data_dir, f"{task}.jsonl")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return [json.loads(line) for line in f if line.strip()]
    from datasets import load_dataset  # may require network

    name = f"{task}_e" if e_split else task
    return list(load_dataset("THUDM/LongBench", name, split="test"))


def truncate_middle(ids: List[int], max_len: int) -> List[int]:
    """Middle truncation preserving head+tail (reference: pred.py:106-110)."""
    if len(ids) <= max_len:
        return ids
    half = max_len // 2
    return ids[:half] + ids[-(max_len - half):]


def predict_task(
    engine: DuoEngine,
    tokenizer,
    task: str,
    data: List[dict],
    max_prompt_len: int,
    out_path: str,
    simulation_tokens: int = 50,
    max_samples: Optional[int] = None,
    stop_ids: tuple = (),
):
    """Greedy predictions for one task, JSONL output (resume by line count).

    simulation_tokens: feed the last N prompt tokens through the decode
    path one-by-one so streaming-cache eviction affects the state exactly
    as in deployment (reference: pred.py:125-142).
    stop_ids: EOS-equivalent token ids — generation output is truncated at
    the first occurrence (the reference trims after the tokenizer's EOS,
    pred.py:152-154; the constructed circuit's end-of-answer marker is
    '.', passed via --stop-text)."""
    done = 0
    if os.path.exists(out_path):
        with open(out_path, encoding="utf-8") as f:
            done = sum(1 for _ in f)
    samples = data[: max_samples or len(data)]
    with open(out_path, "a", encoding="utf-8") as out:
        for idx, sample in enumerate(samples):
            if idx < done:
                continue
            prompt = TASK_PROMPTS[task].format(**{
                "context": sample.get("context", ""),
                "input": sample.get("input", ""),
            })
            ids = truncate_middle(encode_ids(tokenizer, prompt), max_prompt_len)
            gen_len = TASK_MAXGEN[task]
            arr = np.asarray(ids, np.int32)[None]
            sim = min(simulation_tokens, len(ids) - 1)
            if sim > 0:
                cache, _ = engine.prefill(arr[:, :-sim])
                pos = arr.shape[1] - sim  # tokens in the cache so far
                for t in range(sim):
                    nxt, cache = engine.decode_step(
                        cache, torch.as_tensor(arr[:, pos + t]), pos + t
                    )
                # burst decode: replays the engine's captured step on the card.
                # nxt = the first GENERATED token (decode_tokens emits its
                # first input, so feeding the prompt tail here would echo
                # it into the prediction).
                tokens, _ = engine.decode_tokens(
                    cache, nxt, gen_len, length=arr.shape[1],
                )
            else:
                tokens, _ = engine.generate(arr, gen_len)
            out_ids = list(np.asarray(tokens[0]))
            if stop_ids:
                for k, t in enumerate(out_ids):
                    if int(t) in stop_ids:
                        out_ids = out_ids[:k]
                        break
            pred = decode_ids(tokenizer, out_ids)
            rec = {
                "pred": pred,
                "answers": sample.get("answers", []),
                "all_classes": sample.get("all_classes", []),
                "length": sample.get("length", len(ids)),
            }
            out.write(json.dumps(rec, ensure_ascii=False) + "\n")
            out.flush()


def score_file(task: str, pred_path: str) -> float:
    """Standard LongBench scoring: max over gold answers, mean over samples."""
    metric = TASK_METRIC[task]
    scores = []
    with open(pred_path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            pred = rec["pred"]
            if task in ("trec", "triviaqa", "samsum", "lsht"):
                pred = pred.lstrip("\n").split("\n")[0]
            best = 0.0
            for ans in rec.get("answers", []):
                best = max(
                    best,
                    metric(pred, ans, all_classes=rec.get("all_classes"))
                    if metric is M.classification_score
                    else metric(pred, ans),
                )
            scores.append(best)
    return round(100 * float(np.mean(scores)) if scores else 0.0, 2)


def score_file_e(task: str, pred_path: str) -> Dict[str, float]:
    """LongBench-E: scores bucketed by context length (0-4k, 4-8k, 8k+)."""
    metric = TASK_METRIC[task]
    buckets = {"0-4k": [], "4-8k": [], "8k+": []}
    with open(pred_path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            pred = rec["pred"]
            if task in ("trec", "triviaqa", "samsum", "lsht"):
                pred = pred.lstrip("\n").split("\n")[0]
            best = 0.0
            for ans in rec.get("answers", []):
                best = max(
                    best,
                    metric(pred, ans, all_classes=rec.get("all_classes"))
                    if metric is M.classification_score
                    else metric(pred, ans),
                )
            length = rec.get("length", 0)
            key = "0-4k" if length < 4000 else ("4-8k" if length < 8000 else "8k+")
            buckets[key].append(best)
    return {
        k: round(100 * float(np.mean(v)), 2) if v else 0.0
        for k, v in buckets.items()
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="LongBench pred + eval")
    p.add_argument("--tasks", nargs="+", default=["hotpotqa"])
    p.add_argument("--model", default="tiny-gqa")
    p.add_argument("--attn-pattern", default=None)
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--sink", type=int, default=64)
    p.add_argument("--recent", type=int, default=256)
    p.add_argument("--max-prompt-len", type=int, default=31500)
    p.add_argument("--max-cache", type=int, default=65536)
    p.add_argument("--prefill-chunk", type=int, default=8192)
    p.add_argument("--data-dir", default=None, help="dir of <task>.jsonl files")
    p.add_argument("--out-dir", default="longbench_results")
    p.add_argument("--tokenizer", default="byte")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--e-split", action="store_true")
    p.add_argument("--score-only", action="store_true")
    p.add_argument("--invert", action="store_true",
                   help="keep the COMPLEMENT of the pattern's heads full "
                   "(same budget, wrong heads — the ablation control)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ranks, one process each (NCCL when each has a card, else gloo)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stages (parallel/pipeline.py), the cards in turn; generate mode, unquantized")
    p.add_argument("--simulation-tokens", type=int, default=50,
                   help="feed the last N prompt tokens through the "
                   "decode path (reference protocol, pred.py:125-142)")
    p.add_argument("--stop-text", default=None,
                   help="EOS-equivalent text: truncate generations at its "
                   "first token (the constructed circuit ends answers "
                   "with '.'; real models use their tokenizer EOS)")
    p.add_argument("--w8a8", action="store_true",
                   help="INT8 weight/activation linears (the serving format)")
    p.add_argument("--single-bucket", action="store_true",
                   help="pin every step to bucket=max_cache (see evals/niah.py)")
    p.add_argument("--kv-quant", choices=["none", "int4"], default="none",
                   help="INT4 KV cache (W8A8KV4 with --w8a8)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.pp:
        # JAX's --pp restrictions (evals/longbench.py)
        if args.simulation_tokens:
            raise SystemExit("--pp supports generate mode only (no per-token simulation): pass --simulation-tokens 0")
        if args.w8a8 or args.kv_quant != "none" or args.tp:
            raise SystemExit("--pp LongBench runs unquantized and without --tp")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.tp and not args.score_only:
        from ..parallel.mesh import run_ranks

        # rank 0 writes the predictions and the scores; every rank returns the scores
        return run_ranks(_main_rank, args.tp, args=(args,), device=args.device, timeout_s=24 * 3600)[0]
    return _run(args)


def _main_rank(mesh, args):
    from ..parallel.mesh import rank_output_dir

    with rank_output_dir(mesh, args.out_dir) as out_dir:
        return _run(args, mesh, out_dir)


def _run(args, mesh=None, out_dir=None):
    from ..config import DuoConfig
    from ..models.constructed import SPECS
    from ..patterns import load_attn_pattern, sparsify_attention_heads
    from .niah import build_model, cast_for_eval, eval_dtype

    out_dir = out_dir or args.out_dir
    results = {}
    if not args.score_only:
        device = args.device if mesh is None else mesh.device
        # a constructed circuit answers in its passkey grammar, which the
        # few-shot templates that end at {input} (trec, lsht, ...) keep
        params, cfg, _ = build_model(args.model, args.w8a8, device)
        if args.model in SPECS:
            args.tokenizer = "word"
        sink, recent = args.sink, args.recent
        if args.attn_pattern:
            from ..models.convert import reorder_params

            heads, sink, recent = load_attn_pattern(args.attn_pattern)
            heads, _ = sparsify_attention_heads(heads, sparsity=args.sparsity)
            if args.invert:
                heads = 1.0 - heads
            params, nf = reorder_params(params, cfg, heads)
        else:
            nf = (round(cfg.num_kv_heads * (1 - args.sparsity)),) * cfg.num_layers
        if args.w8a8 and args.model != "constructed-8b":
            from ..ops.quant import quantize_params_w8a8

            # quantized AFTER reordering, like a real deployment
            params = quantize_params_w8a8(params)
        duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=tuple(nf),
                        max_cache_size=args.max_cache, prefill_chunk_size=args.prefill_chunk)
        params = cast_for_eval(params, args.model, device)
        if mesh is not None:
            from ..parallel.mesh import shard_params

            params = shard_params(mesh, cfg, duo, params)
        dtype = eval_dtype(args.model, device)
        if args.pp:
            from ..parallel.pipeline import PipelinedEngine, stage_devices

            engine = PipelinedEngine(params, cfg, duo, devices=stage_devices(args.pp, device), dtype=dtype)
        else:
            engine = DuoEngine(params, cfg, duo, dtype=dtype, device=device,
                               kv_quant=args.kv_quant, single_bucket=args.single_bucket, mesh=mesh)
        tokenizer = get_tokenizer(args.tokenizer)
        stop_ids = ()
        if args.stop_text:
            stop_ids = tuple(encode_ids(tokenizer, args.stop_text)[-1:])
        for task in args.tasks:
            data = load_task_data(task, args.data_dir, args.e_split)
            out_path = os.path.join(out_dir, f"{task}.jsonl")
            predict_task(engine, tokenizer, task, data, args.max_prompt_len, out_path,
                         simulation_tokens=args.simulation_tokens, max_samples=args.max_samples,
                         stop_ids=stop_ids)
    for task in args.tasks:
        out_path = os.path.join(out_dir, f"{task}.jsonl")
        if os.path.exists(out_path):
            results[task] = (score_file_e(task, out_path) if args.e_split
                             else score_file(task, out_path))
    if mesh is None or mesh.rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(results, f, indent=2, ensure_ascii=False)
        print(json.dumps(results, indent=2, ensure_ascii=False))
    return results


if __name__ == "__main__":
    main()
