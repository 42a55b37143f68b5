"""End-to-end accuracy loop: a retrieval-capable LM, gate training, then the
three-way retrieval eval through the real engine.

Counterpart of duo_attention_tpu/evals/accuracy_loop.py:

1. Obtain an LM that solves the multi-passkey task with full attention: the
   constructed induction circuit (``models/constructed.py``, its retrieval
   heads KNOWN: layer 1, heads 0 and 1) or a tiny LM pretrained here
   (``train/pretrain.py``).
2. Train its gates with ``GateTrainer`` to a pattern.
3. Generate each passkey answer through ``DuoEngine`` with every head full,
   with the trained pattern at the target sparsity, and with its inverse
   (same budget, wrong heads), in the engine's own dtype and, with
   ``quantized_eval``, in W8A8KV4.

``build_engine`` reorders the weights for a binary head pattern (the
retrieval heads first, as a real checkpoint is deployed), optionally
quantizes them to W8A8 after the reorder, and builds the ``DuoEngine``;
``eval_retrieval`` generates each sample's first answer and scores it by
word overlap with the expected code. On the card the engines run in bf16
(the kernels' dtype); on the CPU in float32, as the JAX loop does. The
default circuit is the reference's 64-wide ``constructed`` on either device
(the kernels take head_dim 64 and 128); ``lm="constructed-d128"`` is the 8B
graft's small twin at head_dim 128 (retrieval heads layer 2, heads 0 and 1;
a port addition).

Run on the card: ``python -m duo_attention_tpu_torch.evals.accuracy_loop
--out-dir chiprun_out/accuracy_loop --fresh``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import DuoConfig, ModelConfig
from ..engine import DuoEngine
from ..models.convert import reorder_params
from ..patterns import load_attn_pattern, sparsify_attention_heads
from ..tokenizer import decode_ids, get_tokenizer
from ..train.data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator
from ..utils import resolve_device
from .metrics import word_overlap_score


def build_engine(params, cfg, binary_heads, sink, recent, max_cache, chunk, dtype=torch.float32,
                 w8a8=False, kv_quant="none", device="cuda"):
    """Reorder the weights for a binary pattern and build the engine, the
    load path a real checkpoint goes through. With ``w8a8`` the reordered
    weights are quantized to W8A8 (weights already in that form are reordered
    as they are); with ``kv_quant="int4"`` the full heads' cache is INT4."""
    reordered, num_full = reorder_params(params, cfg, binary_heads)
    if w8a8:
        from ..ops.quant import quantize_params_w8a8

        reordered = quantize_params_w8a8(reordered)
    duo = DuoConfig(sink_size=sink, recent_size=recent, num_full_kv_heads=num_full,
                    max_cache_size=max_cache, prefill_chunk_size=chunk)
    return DuoEngine(reordered, cfg, duo, batch_size=1, dtype=dtype, device=device, kv_quant=kv_quant)


def eval_retrieval(engine, tokenizer, dataset, n_samples: int, offset: int = 60_000) -> dict:
    """Generate each sample's first answer through the engine; score by word
    overlap with the expected code (exact match reported too)."""
    overlaps, exacts = [], []
    for i in range(n_samples):
        ids, answer = dataset.eval_prompt(offset + i)
        # a generous budget for either tokenizer: ~1 token a word (word), a
        # character (byte)
        toks, _ = engine.generate(ids[None], max_new_tokens=len(answer) + 8)
        text = decode_ids(tokenizer, toks[0])
        overlaps.append(word_overlap_score(text, answer))
        exacts.append(float(text.strip().startswith(answer)))
    return {"word_overlap": float(np.mean(overlaps)), "exact_match": float(np.mean(exacts)),
            "n": n_samples}


def _cast_floats(params, dtype):
    """The params with every floating tensor but the W8A8 scales in ``dtype``."""

    def cast(tensors):
        return {k: v if k.endswith("_scale") or not v.is_floating_point() else v.to(dtype)
                for k, v in tensors.items()}

    out = cast({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = [cast(layer) for layer in params["layers"]]
    return out


def run_loop(out_dir: str, pretrain_steps: int = 3000, gate_steps: int = 600, eval_samples: int = 16,
             sparsity: float = 0.5, cfg: Optional[ModelConfig] = None, ctx_min: int = 256, ctx_max: int = 1024,
             sink: int = 16, recent: int = 64, batch_size: int = 8, reuse_lm: bool = True, lm: str = "constructed",
             quantized_eval: bool = True, device="cuda") -> dict:
    """The loop on ``device`` (the card unless the caller asks for the
    CPU); writes ``report.json`` (the JAX loop's keys) into ``out_dir`` and
    returns it. With ``reuse_lm`` a pretrained LM or a gate pattern already
    in ``out_dir`` is reused."""
    from ..models.constructed import build_params, spec_for
    from ..train.pretrain import TINY_LM, PretrainConfig, answer_token_accuracy, load_lm, pretrain, save_lm
    from ..train.trainer import GateTrainConfig, GateTrainer

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    # word-level tokens: passkey retrieval becomes the canonical induction copy task
    tokenizer = get_tokenizer("word")
    dcfg = PasskeyDataConfig(context_length_min=min(128, ctx_min), context_length_max=ctx_max,
                             num_passkeys=2, passkey_length=3)
    dataset = MultiPasskeyDataset(tokenizer, dcfg, num_samples=100_000)

    # -- 1. a retrieval-capable LM (full attention) -------------------------
    losses = []
    if lm in ("constructed", "constructed-long", "constructed-d128"):
        spec = spec_for(lm)
        cfg = spec.model_config()
        params = build_params(tokenizer, spec=spec, device=device)
    else:
        cfg = cfg or TINY_LM
        lm_path = os.path.join(out_dir, "tiny_lm.npz")
        if reuse_lm and os.path.exists(lm_path):
            params = load_lm(lm_path, cfg, device=device)
            print(f"[loop] reusing pretrained LM at {lm_path}", flush=True)
        else:
            params, losses = pretrain(cfg, PretrainConfig(num_steps=pretrain_steps, batch_size=batch_size), dcfg,
                                      tokenizer, device=device)
            save_lm(params, lm_path)
    tf_acc = answer_token_accuracy(params, cfg, dataset, n_samples=16, offset=50_000)
    print(f"[loop] teacher-forced answer accuracy (full attn): {tf_acc:.3f}", flush=True)

    # -- 2. gate training -----------------------------------------------------
    pattern_dir = os.path.join(out_dir, "pattern")
    tcfg = GateTrainConfig(lr=0.02, reg_weight=0.05, num_steps=gate_steps, sink_size=sink, recent_size=recent,
                           batch_size=batch_size, save_steps=max(gate_steps // 4, 1), output_dir=pattern_dir,
                           block_k=128)
    gates_tsv = os.path.join(pattern_dir, "full_attention_heads.tsv")
    if reuse_lm and os.path.exists(gates_tsv):
        print(f"[loop] reusing gate pattern at {gates_tsv}", flush=True)
    else:
        trainer = GateTrainer(params, cfg, tcfg, device=device)
        trainer.train(data_iterator(dataset, batch_size, pad_to=ctx_max + 256), log_every=max(gate_steps // 10, 1))
    gates, _, _ = load_attn_pattern(pattern_dir)

    # -- 3. three-way retrieval eval -----------------------------------------
    binary, actual_sparsity = sparsify_attention_heads(gates, sparsity=sparsity)
    dtype = torch.float32
    if device.type == "cuda":  # the kernels take bf16 tensors
        dtype = torch.bfloat16
        params = _cast_floats(params, dtype)
    variants = [("", {})]
    if quantized_eval:  # the W8A8KV4 serving stack
        variants.append(("_w8a8kv4", {"w8a8": True, "kv_quant": "int4"}))
    results = {}
    for name, pattern in (("full_attention", np.ones_like(binary)), ("trained_pattern", binary),
                          ("inverted_pattern", 1.0 - binary)):
        for suffix, qkw in variants:
            eng = build_engine(params, cfg, pattern, sink, recent, ctx_max + 512, 256, dtype=dtype, device=device,
                               **qkw)
            r = results[name + suffix] = eval_retrieval(eng, tokenizer, dataset, eval_samples)
            print(f"[loop] {name}{suffix}: overlap={r['word_overlap']:.3f} exact={r['exact_match']:.3f}", flush=True)

    report = {
        "lm": lm,
        "model": dataclasses.asdict(cfg),
        "pretrain_steps": pretrain_steps,
        "pretrain_loss_curve": losses,
        "teacher_forced_answer_acc": tf_acc,
        "gate_steps": gate_steps,
        "sparsity_target": sparsity,
        "sparsity_actual": float(actual_sparsity),
        "gates": np.asarray(gates).tolist(),
        "sink": sink,
        "recent": recent,
        "results": results,
    }
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="end-to-end accuracy loop")
    p.add_argument("--out-dir", default="artifacts/accuracy_loop")
    p.add_argument("--pretrain-steps", type=int, default=3000)
    p.add_argument("--gate-steps", type=int, default=600)
    p.add_argument("--eval-samples", type=int, default=16)
    p.add_argument("--sparsity", type=float, default=0.5)
    p.add_argument("--lm", choices=["constructed", "constructed-long", "constructed-d128", "pretrain"],
                   default="constructed")
    p.add_argument("--fresh", action="store_true", help="retrain even if artifacts exist")
    p.add_argument("--no-quant", action="store_true", help="skip the W8A8 + INT4-KV engine variants")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    report = run_loop(args.out_dir, pretrain_steps=args.pretrain_steps, gate_steps=args.gate_steps,
                      eval_samples=args.eval_samples, sparsity=args.sparsity, reuse_lm=not args.fresh, lm=args.lm,
                      quantized_eval=not args.no_quant, device=args.device)
    print(json.dumps({k: v["word_overlap"] for k, v in report["results"].items()}))


if __name__ == "__main__":
    main()
