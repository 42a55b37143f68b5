"""Synthetic HF checkpoints at exact real-model geometry.

The port's own copy of duo_attention_tpu/models/synth.py: it writes the same
bytes as the JAX package's writer (tests/test_torch_evals.py). A
random-weight checkpoint in the HuggingFace safetensors layout ([out, in]
projections, transformers tensor names) plus config.json, streamed one
tensor at a time so peak host memory is about the largest tensor, not the
model: the converter (``models/convert.py``) is proven at the real
Llama-3-8B geometry with it. bf16 words come from torch's round-to-nearest-
even conversion (the JAX package's writer uses ml_dtypes, whose rounding is
the same).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig


def _hf_config_dict(cfg: ModelConfig) -> dict:
    return {
        "model_type": cfg.model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
        "torch_dtype": "bfloat16",
    }


def _tensor_shapes(cfg: ModelConfig):
    """(name, shape) pairs in HF layout/naming order."""
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    yield "model.embed_tokens.weight", (V, E)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        yield pre + "input_layernorm.weight", (E,)
        yield pre + "post_attention_layernorm.weight", (E,)
        yield pre + "self_attn.q_proj.weight", (Hq * D, E)
        yield pre + "self_attn.k_proj.weight", (Hkv * D, E)
        yield pre + "self_attn.v_proj.weight", (Hkv * D, E)
        yield pre + "self_attn.o_proj.weight", (E, Hq * D)
        yield pre + "mlp.gate_proj.weight", (I, E)
        yield pre + "mlp.up_proj.weight", (I, E)
        yield pre + "mlp.down_proj.weight", (E, I)
    yield "model.norm.weight", (E,)
    if not cfg.tie_word_embeddings:
        yield "lm_head.weight", (V, E)


def _encode(t: np.ndarray, dtype: str) -> bytes:
    """float32 values as the bytes of ``dtype`` (little-endian, as numpy
    writes them)."""
    if dtype == "BF16":
        return torch.from_numpy(np.ascontiguousarray(t)).to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(t.astype({"F32": np.float32, "F16": np.float16}[dtype])).tobytes()


def write_synth_checkpoint(
    out_dir: str,
    cfg: ModelConfig,
    seed: int = 0,
    dtype: str = "BF16",
    scale: Optional[float] = None,
) -> str:
    """Write ``model.safetensors`` + ``config.json`` at ``cfg``'s geometry.

    The safetensors container is written by hand (u64le header length,
    JSON header, raw data) so tensors stream straight to disk — a 16 GB
    8B checkpoint never lives in RAM. Norm weights are 1.0 and
    projections ~N(0, 1/sqrt(fan_in)) so the resulting model is numerically
    tame (finite logits through 32 layers).
    Returns ``out_dir``.
    """
    itemsize = {"BF16": 2, "F32": 4, "F16": 2}[dtype]
    os.makedirs(out_dir, exist_ok=True)
    shapes = list(_tensor_shapes(cfg))
    header = {}
    off = 0
    for name, shape in shapes:
        n = int(np.prod(shape)) * itemsize
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    hjson = json.dumps(header).encode()
    pad = (-len(hjson)) % 8  # align the data section
    hjson += b" " * pad

    rng = np.random.default_rng(seed)
    path = os.path.join(out_dir, "model.safetensors")
    with open(path, "wb") as f:
        f.write(np.uint64(len(hjson)).tobytes())
        f.write(hjson)
        for name, shape in shapes:
            if name.endswith("norm.weight"):
                t = np.ones(shape, np.float32)
            else:
                s = scale if scale is not None else shape[-1] ** -0.5
                t = rng.standard_normal(shape, np.float32) * s
            f.write(_encode(t, dtype))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(_hf_config_dict(cfg), f, indent=1)
    return out_dir


def main(argv=None):
    import argparse

    from ..config import PRESETS

    p = argparse.ArgumentParser(
        description="write a synthetic HF checkpoint at real geometry"
    )
    p.add_argument("--model", default="Llama-3-8B-Instruct-Gradient-1048k")
    p.add_argument("--num-layers", type=int, default=None,
                   help="depth override (full geometry per layer)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = PRESETS[args.model]
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    write_synth_checkpoint(args.out_dir, cfg, seed=args.seed)
    print(args.out_dir)


if __name__ == "__main__":
    main()
