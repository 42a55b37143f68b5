"""Attention-pattern artifacts: TSV IO, sparsification, head ordering.

Byte-compatible with the reference artifact format so reference-trained
patterns load directly (reference: duo_attn/utils.py:326-381,
attn_patterns/<model>/<run>/full_attention_heads.tsv + config.json).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def load_attn_pattern(attn_load_dir: str):
    """Load gate matrix + sink/recent sizes from a pattern directory.

    Returns ``(full_attention_heads [num_layers, num_kv_heads] float in [0,1],
    sink_size, recent_size)``. Mirrors duo_attn/utils.py:326-336.
    """
    full_attention_heads = np.loadtxt(
        os.path.join(attn_load_dir, "full_attention_heads.tsv"),
        dtype=float,
        delimiter="\t",
    )
    full_attention_heads = np.clip(full_attention_heads, 0, 1)
    with open(os.path.join(attn_load_dir, "config.json")) as f:
        config = json.load(f)
    return full_attention_heads, config["sink_size"], config["recent_size"]


def save_attn_pattern(
    attn_save_dir: str,
    full_attention_heads: np.ndarray,
    sink_size: int,
    recent_size: int,
    extra_config: Optional[dict] = None,
) -> None:
    """Save gates + config in the reference's artifact format."""
    os.makedirs(attn_save_dir, exist_ok=True)
    save_full_attention_heads(
        full_attention_heads,
        os.path.join(attn_save_dir, "full_attention_heads.tsv"),
    )
    config = dict(extra_config or {})
    config["sink_size"] = sink_size
    config["recent_size"] = recent_size
    with open(os.path.join(attn_save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def save_full_attention_heads(full_attention_heads, output_filename: str) -> None:
    np.savetxt(output_filename, np.array(full_attention_heads), delimiter="\t")


def sparsify_attention_heads(
    full_attention_heads: np.ndarray,
    threshold: Optional[float] = None,
    sparsity: Optional[float] = None,
    seed: int = 0,
):
    """Binarize soft gates to {0,1} at a quantile or absolute threshold.

    Same semantics as duo_attn/utils.py:353-373 (quantile threshold at the
    requested sparsity with a tiny tie-break noise), but with a seeded
    generator for reproducibility, and without the reference's latent bug of
    dereferencing ``sparsity`` when only ``threshold`` is given
    (SURVEY.md §7.3 notes this as a quirk not to replicate).

    Returns ``(binary_heads, actual_sparsity)``.
    """
    full_attention_heads = np.asarray(full_attention_heads, dtype=float).copy()
    rng = np.random.default_rng(seed)
    full_attention_heads += rng.uniform(0, 1e-6, full_attention_heads.shape)

    if sparsity is not None:
        threshold = np.quantile(full_attention_heads, sparsity)
        if sparsity >= 1:
            threshold = 2.0  # all heads pruned
        elif sparsity <= 0:
            threshold = -1.0  # no heads pruned
    else:
        assert threshold is not None, "Either threshold or sparsity must be provided"

    binary = (full_attention_heads >= threshold).astype(float)
    actual_sparsity = 1.0 - float(np.mean(binary))
    return binary, actual_sparsity


def visualize_head_map(
    full_attention_heads, output_path: Optional[str] = None, title: str = ""
):
    """Heatmap of the (layer x KV-head) gate matrix.

    Counterpart of the reference's wandb-logged matplotlib heatmap
    (duo_attn/utils.py:312-323, logged from train.py:179-195). Returns the
    figure; saves to output_path when given.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    heads = np.atleast_2d(np.asarray(full_attention_heads, dtype=float))
    fig, ax = plt.subplots(
        figsize=(max(4, heads.shape[1] * 0.35), max(3, heads.shape[0] * 0.22))
    )
    im = ax.imshow(heads, cmap="coolwarm", vmin=0.0, vmax=1.0, aspect="auto")
    ax.set_xlabel("KV head")
    ax.set_ylabel("layer")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, label="gate (1 = retrieval)")
    fig.tight_layout()
    if output_path:
        fig.savefig(output_path, dpi=120)
        plt.close(fig)
    return fig


# ---------------------------------------------------------------------------
# Head ordering
# ---------------------------------------------------------------------------


def head_permutation(layer_gates: np.ndarray) -> Tuple[np.ndarray, int]:
    """Per-layer KV-head permutation putting retrieval heads first.

    The reference physically reorders q/k/v/o projection weights so full
    heads occupy a leading contiguous slice (duo_attn/patch/utils.py:6-45);
    we compute the same permutation (stable, so relative order within each
    group is preserved) and apply it to our param pytree at load time.

    Returns ``(perm [num_kv_heads] int, num_full int)`` where
    ``new_head[i] = old_head[perm[i]]``.
    """
    layer_gates = np.asarray(layer_gates)
    full_mask = layer_gates > 0.5
    full_idx = np.nonzero(full_mask)[0]
    stream_idx = np.nonzero(~full_mask)[0]
    perm = np.concatenate([full_idx, stream_idx])
    return perm, int(full_mask.sum())


def expand_kv_perm(perm: np.ndarray, repeats: int) -> np.ndarray:
    """Expand a KV-head permutation to a channel permutation.

    Each KV head owns ``repeats`` consecutive channels (``head_dim`` for k/v
    projections, ``num_kv_groups * head_dim`` for q and o projections —
    matching the reference's repeat_interleave semantics,
    duo_attn/patch/utils.py:14-16).
    """
    perm = np.asarray(perm)
    base = perm[:, None] * repeats + np.arange(repeats)[None, :]
    return base.reshape(-1)


def num_full_kv_heads_per_layer(binary_heads: np.ndarray) -> Tuple[int, ...]:
    """Per-layer retrieval-head counts from a binarized gate matrix."""
    binary_heads = np.atleast_2d(np.asarray(binary_heads))
    return tuple(int((row > 0.5).sum()) for row in binary_heads)


def reordered_gate_matrix(binary_heads: np.ndarray) -> np.ndarray:
    """Gates after reordering: [1...1, 0...0] per layer.

    Mirrors reorder_full_attn_heads (duo_attn/patch/utils.py:37-45).
    """
    binary_heads = np.atleast_2d(np.asarray(binary_heads))
    out = np.zeros_like(binary_heads)
    for i, n in enumerate(num_full_kv_heads_per_layer(binary_heads)):
        out[i, :n] = 1.0
    return out
