"""Needle-in-a-haystack (NIAH) evaluation harness.

Counterpart of duo_attention_tpu/evals/niah.py (itself the counterpart of
the reference's eval/needle/needle_in_haystack.py and visualize.py):
context-length x depth grid, chunked prefill through the engine, optional
per-token "decoding simulation", greedy generation, unigram-ROUGE x10 cell
scores, per-cell JSON results with resume-by-existence, and a heatmap
(matplotlib, imported only by ``visualize``). Haystack text comes from a
directory of .txt files or the deterministic procedural generator, whose
words and draws equal the JAX package's.

Run on the card (the 8B-geometry constructed circuit in W8A8KV4, the trained
pattern at sparsity 0.5):

    python -m duo_attention_tpu_torch.evals.niah --model constructed-8b --w8a8 \
        --kv-quant int4 --single-bucket --attn-pattern artifacts/niah_8b/pattern \
        --ctx 32768 --depths 9 --prefill-chunk 4096 --max-cache 131200 \
        --output-dir chiprun_out/niah_8b

``--tp N`` runs N tensor-parallel ranks (``parallel/mesh.py``), one process
each: NCCL when each has a card of its own, gloo when they share one or with
``--device cpu``; rank 0 writes the results. ``--pp N`` runs N pipeline
stages in one process (``parallel/pipeline.py``; stage s on card s mod the
cards present, so a single card takes them all in turn), in generate mode
and unquantized, as JAX's ``--pp``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..engine import DuoEngine
from ..tokenizer import decode_ids, encode_ids, get_tokenizer
from .metrics import niah_score, word_overlap_score

DEFAULT_NEEDLE = (
    "\nThe one absolutely vital fact to remember is that the silver otter "
    "keeps its treasure under the old stone bridge in Harmony Creek.\n"
)
DEFAULT_QUESTION = (
    "\nQuestion: Where does the silver otter keep its treasure? Answer:"
)
DEFAULT_ANSWER = "under the old stone bridge in Harmony Creek"

# NOTE: disjoint from train.data._CODE_WORDS — a code word occurring in
# the filler creates false continuation evidence for retrieval models
# (the token after a haystack occurrence is arbitrary)
_WORDS = (
    "river meadow lantern harvest compass timber orchard saddle copper "
    "bellows brook thicket granite whisper barley crag hollow ember "
    "drift pasture mill crossing ledger wharf spindle furrow"
).split()


def procedural_haystack(num_chars: int, seed: int = 0) -> str:
    """Deterministic filler prose (stands in for a text corpus)."""
    rng = np.random.default_rng(seed)
    out = []
    n = 0
    while n < num_chars:
        k = rng.integers(8, 16)
        words = rng.choice(_WORDS, size=k)
        sent = " ".join(words).capitalize() + ". "
        out.append(sent)
        n += len(sent)
    return "".join(out)[:num_chars]


def load_haystack(haystack_dir: Optional[str], num_chars: int) -> str:
    if haystack_dir and os.path.isdir(haystack_dir):
        texts = []
        n = 0
        for path in sorted(glob.glob(os.path.join(haystack_dir, "*.txt"))):
            with open(path, encoding="utf-8", errors="ignore") as f:
                t = f.read()
            texts.append(t)
            n += len(t)
            if n >= num_chars:
                break
        if texts:
            text = "".join(texts)
            while len(text) < num_chars:  # repeat if corpus too small
                text += text
            return text[:num_chars]
    return procedural_haystack(num_chars)


@dataclass
class NIAHConfig:
    context_lengths: List[int] = field(
        default_factory=lambda: [1024, 2048, 4096, 8192]
    )
    depth_percents: List[float] = field(
        default_factory=lambda: list(np.linspace(0, 100, 5))
    )
    needle: str = DEFAULT_NEEDLE
    question: str = DEFAULT_QUESTION
    answer: str = DEFAULT_ANSWER
    gen_tokens: int = 50
    simulation_tokens: int = 0  # feed the last N tokens one-by-one (decode
    # path exercise, reference :269-299)
    output_dir: str = "niah_results"
    resume: bool = True
    haystack_dir: Optional[str] = None


class NIAHTester:
    """Grid evaluator. Engine and tokenizer are injected (no HF patching)."""

    def __init__(self, engine: DuoEngine, tokenizer, config: NIAHConfig):
        self.engine = engine
        self.tokenizer = tokenizer
        self.cfg = config
        os.makedirs(config.output_dir, exist_ok=True)

    def _cell_path(self, ctx_len: int, depth: float) -> str:
        return os.path.join(
            self.cfg.output_dir, f"ctx_{ctx_len}_depth_{int(round(depth))}.json"
        )

    def _haystack_ids(self, num_chars: int) -> List[int]:
        """Encoded haystack, cached — at 1M-token contexts generating and
        encoding ~6 MB of filler dominates a cell's host time, and every
        depth in a context row reuses the identical text."""
        if getattr(self, "_hay_cache", None) is None or (
            self._hay_cache[0] != num_chars
        ):
            text = load_haystack(self.cfg.haystack_dir, num_chars)
            self._hay_cache = (num_chars, self._encode(text))
        return self._hay_cache[1]

    def _encode(self, text: str) -> List[int]:
        """Encode a prompt PIECE: strip the tokenizer's leading BOS so
        concatenation does not scatter sink anchors mid-sequence."""
        ids = encode_ids(self.tokenizer, text)
        bos = getattr(self.tokenizer, "bos_token_id", None)
        if bos is not None and ids and ids[0] == bos:
            ids = ids[1:]
        return ids

    def build_prompt_ids(self, ctx_len: int, depth_percent: float) -> List[int]:
        """Token-budgeted haystack with the needle inserted at depth%;
        one BOS leads the sequence (the attention-sink anchor)."""
        # ~4 chars/token is a safe overestimate for byte/BPE tokenizers
        hay_ids = self._haystack_ids(ctx_len * 6)
        q_ids = self._encode(self.cfg.question)
        needle_ids = self._encode(self.cfg.needle)
        bos = getattr(self.tokenizer, "bos_token_id", None)
        lead = [] if bos is None else [bos]
        budget = ctx_len - len(q_ids) - len(needle_ids) - len(lead)
        hay_ids = hay_ids[:budget]
        insert_at = int(len(hay_ids) * depth_percent / 100.0)
        return (lead + hay_ids[:insert_at] + needle_ids
                + hay_ids[insert_at:] + q_ids)

    def run_cell(self, ctx_len: int, depth_percent: float) -> dict:
        path = self._cell_path(ctx_len, depth_percent)
        if self.cfg.resume and os.path.exists(path):
            with open(path) as f:
                return json.load(f)

        ids = self.build_prompt_ids(ctx_len, depth_percent)
        prompt = np.asarray(ids, dtype=np.int32)[None, :]
        t0 = time.perf_counter()
        if self.cfg.simulation_tokens > 0:
            sim = min(self.cfg.simulation_tokens, prompt.shape[1] - 1)
            cache, _ = self.engine.prefill(prompt[:, :-sim])
            pos = prompt.shape[1] - sim  # tokens in the cache so far
            for t in range(sim):
                nxt, cache = self.engine.decode_step(
                    cache, torch.as_tensor(prompt[:, pos + t]), pos + t
                )
            # generate from the simulated state (burst decode: replays the
            # engine's captured step on the card). nxt = the first
            # GENERATED token — decode_tokens emits its first input, so
            # feeding the prompt tail here would echo it into the response.
            tokens, cache = self.engine.decode_tokens(
                cache, nxt, self.cfg.gen_tokens,
                length=prompt.shape[1],
            )
        else:
            tokens, _ = self.engine.generate(prompt, self.cfg.gen_tokens)
        latency = time.perf_counter() - t0

        response = decode_ids(self.tokenizer, tokens[0])
        result = {
            "context_length": ctx_len,
            "depth_percent": depth_percent,
            "response": response,
            "needle_answer": self.cfg.answer,
            "score": niah_score(response, self.cfg.answer),
            "word_overlap": word_overlap_score(response, self.cfg.answer),
            "latency_s": latency,
        }
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    def run(self) -> List[dict]:
        results = []
        for ctx_len in self.cfg.context_lengths:
            for depth in self.cfg.depth_percents:
                r = self.run_cell(ctx_len, depth)
                print(
                    f"[niah] ctx={ctx_len} depth={depth:.0f}% "
                    f"score={r['score']:.2f} overlap={r['word_overlap']:.2f}"
                )
                results.append(r)
        return results


def visualize(results_dir: str, output_path: Optional[str] = None):
    """Depth x context heatmap of word-overlap scores
    (counterpart of eval/needle/visualize.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "ctx_*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    if not cells:
        raise FileNotFoundError(f"no results in {results_dir}")
    ctxs = sorted({c["context_length"] for c in cells})
    depths = sorted({c["depth_percent"] for c in cells})
    grid = np.full((len(depths), len(ctxs)), np.nan)
    for c in cells:
        grid[depths.index(c["depth_percent"]), ctxs.index(c["context_length"])] = c[
            "word_overlap"
        ]
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(grid, aspect="auto", cmap="RdYlGn", vmin=0, vmax=1)
    ax.set_xticks(range(len(ctxs)), [f"{c//1000}k" if c >= 1000 else str(c) for c in ctxs])
    ax.set_yticks(range(len(depths)), [f"{d:.0f}%" for d in depths])
    ax.set_xlabel("Context Length")
    ax.set_ylabel("Needle Depth")
    ax.set_title("Needle-in-a-Haystack retrieval accuracy")
    fig.colorbar(im)
    out = output_path or os.path.join(results_dir, "heatmap.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def build_model(model: str, w8a8: bool, device):
    """(params, cfg, needle overrides) for a preset name or a constructed
    circuit. A constructed circuit gets the word tokenizer's ids and the
    needle, question and answer of its passkey grammar; ``constructed-8b``
    is built directly in W8A8 form on ``device`` (its float32 weights would
    take 23 GB)."""
    from ..config import PRESETS
    from ..models import llama
    from ..models.constructed import SPECS, build_params, build_params_w8a8, spec_for
    from ..train.data import _CODE_WORDS, _NAMES

    if model not in SPECS:
        cfg = PRESETS[model]
        return llama.init_params(cfg, seed=0, device=device), cfg, {}
    # The hand-built retrieval circuit (models/constructed.py): it really
    # retrieves, and its retrieval heads are known, so the depth x context
    # grid means something. 'constructed-8b' grafts it into the full
    # Llama-3-8B geometry.
    spec = spec_for(model)
    cfg = spec.model_config()
    if model == "constructed-8b":
        if not w8a8:
            raise ValueError("constructed-8b is built in W8A8 form: pass --w8a8")
        params = build_params_w8a8(get_tokenizer("word"), spec=spec, device=device)
    else:
        params = build_params(get_tokenizer("word"), spec=spec, device=device)
    # needle/question in the circuit's passkey grammar (train/data.py
    # format); haystack words are disjoint from the code words.
    name, code = _NAMES[7], " ".join(_CODE_WORDS[9:12])
    needle = {"needle": f" Remember this: the secret code of {name} is {code}. ",
              "question": f"\nQuestion: the secret code of {name} is",
              "answer": code}
    return params, cfg, needle


def eval_dtype(model: str, device="cpu"):
    """Constructed circuits run their score margins in float32, but the 8B
    graft, which is built in W8A8 and runs in bf16 (the serving dtype);
    presets run in bf16. On the card everything runs in bf16, the dtype its
    kernels take."""
    from ..models.constructed import SPECS

    if torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32 if model in SPECS and model != "constructed-8b" else torch.bfloat16


def cast_for_eval(params, model: str, device):
    """``params`` with their floating tensors (the W8A8 scales kept) in
    ``eval_dtype(model, device)``."""
    from .accuracy_loop import _cast_floats

    return _cast_floats(params, eval_dtype(model, device))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="NIAH evaluation")
    p.add_argument("--model", default="tiny-gqa",
                   help="preset name, or a constructed circuit ('constructed', "
                   "'constructed-long', 'constructed-8b', 'constructed-d128')")
    p.add_argument("--attn-pattern", default=None, help="pattern dir (TSV+config)")
    p.add_argument("--invert", action="store_true",
                   help="keep the COMPLEMENT of the pattern's heads full "
                   "(same budget, wrong heads — the ablation control)")
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--sink", type=int, default=64)
    p.add_argument("--recent", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=8192)
    p.add_argument("--max-cache", type=int, default=65536)
    p.add_argument("--ctx", type=int, nargs="+", default=[1024, 2048, 4096])
    p.add_argument("--depths", type=int, default=5)
    p.add_argument("--tokenizer", default="byte")
    p.add_argument("--haystack-dir", default=None)
    p.add_argument("--output-dir", default="niah_results")
    p.add_argument("--simulation-tokens", type=int, default=0)
    p.add_argument("--w8a8", action="store_true",
                   help="quantize weights to W8A8 after reordering (the "
                   "serving stack)")
    p.add_argument("--kv-quant", choices=["none", "int4"], default="none",
                   help="KV-cache quantization (int4 = the KV4 half of W8A8KV4)")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--single-bucket", action="store_true",
                   help="pin every step to bucket=max_cache (the kernels "
                   "stop at the live length)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ranks, one process each (NCCL when each has a card, else gloo)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stages (parallel/pipeline.py), the cards in turn; generate mode, unquantized")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.pp:
        # JAX's --pp restrictions (evals/niah.py)
        if args.simulation_tokens:
            raise SystemExit("--pp supports generate mode only (no per-token simulation): pass --simulation-tokens 0")
        if args.w8a8 or args.kv_quant != "none" or args.tp:
            raise SystemExit("--pp NIAH runs unquantized and without --tp")
    if args.tp:
        from ..parallel.mesh import run_ranks

        # rank 0 writes the results; every rank returns them
        return run_ranks(_main_rank, args.tp, args=(args,), device=args.device, timeout_s=24 * 3600)[0]
    return _run(args)


def _main_rank(mesh, args):
    from ..parallel.mesh import rank_output_dir

    with rank_output_dir(mesh, args.output_dir) as output_dir:
        return _run(args, mesh, output_dir)


def _run(args, mesh=None, output_dir=None):
    from ..config import DuoConfig
    from ..patterns import load_attn_pattern, sparsify_attention_heads

    device = args.device if mesh is None else mesh.device
    params, cfg, needle = build_model(args.model, args.w8a8, device)
    if needle:
        args.tokenizer = "word"
    sink, recent = args.sink, args.recent
    if args.attn_pattern:
        from ..models.convert import reorder_params

        heads, sink, recent = load_attn_pattern(args.attn_pattern)
        heads, _ = sparsify_attention_heads(heads, sparsity=args.sparsity)
        if args.invert:
            heads = 1.0 - heads
        # retrieval-heads-first permutation: the deploy step a real
        # checkpoint goes through (convert.load_hf_model)
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
    kw = {}
    if needle:
        # a power-of-two budget: one burst length
        gen = 1 << (len(needle["answer"].split()) + 2).bit_length()
        kw = dict(needle, gen_tokens=gen)
    config = NIAHConfig(
        context_lengths=args.ctx,
        depth_percents=list(np.linspace(0, 100, args.depths)),
        output_dir=output_dir or args.output_dir,
        haystack_dir=args.haystack_dir,
        simulation_tokens=args.simulation_tokens,
        **kw,
    )
    results = NIAHTester(engine, tokenizer, config).run()
    if args.visualize and (mesh is None or mesh.rank == 0):
        print("heatmap:", visualize(args.output_dir))
    return results


if __name__ == "__main__":
    main()
