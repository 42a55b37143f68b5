"""Retrieval accuracy through the real engine: ``build_engine`` and
``eval_retrieval`` of duo_attention_tpu/evals/accuracy_loop.py.

``build_engine`` reorders the weights for a binary head pattern (the
retrieval heads first, as a real checkpoint is deployed), optionally
quantizes them to W8A8 after the reorder, and builds the ``DuoEngine``;
``eval_retrieval`` generates each passkey sample's first answer through it
and scores it by word overlap with the expected code. With a trained pattern
the constructed circuit (``models/constructed.py``) retrieves every answer;
with the inverted pattern (same budget, wrong heads) it fails.

The rest of the JAX module, ``run_loop`` (pretrain, gate training, then the
three-way eval) and its CLI ``main``, waits for the training slice (ROADMAP
item 7): it needs the gate trainer, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DuoConfig
from ..engine import DuoEngine
from ..models.convert import reorder_params
from ..tokenizer import decode_ids
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
