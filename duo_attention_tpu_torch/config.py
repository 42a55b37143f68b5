"""Model and DuoAttention configuration.

The PyTorch port's own copy of ``duo_attention_tpu/config.py`` (the port
imports nothing from the JAX package). Same fields, presets and defaults;
configs are frozen dataclasses so they hash and compare by value.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE scaling config (subset of HF's rope_scaling dict).

    ``rope_type``: "default" | "linear" | "llama3".
    """

    rope_type: str = "default"
    factor: float = 1.0
    # llama3-style scaling parameters
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config covering Llama-2/3, Mistral and Mixtral-dense.

    The reference patches HF models per ``model.config.model_type``
    (duo_attn/patch/__init__.py:22-55); here one functional implementation
    covers all supported families, parameterized by this config. Notes:
    * model_type "mixtral" routes to the dense path exactly as the
      reference does (its mistral patch only replaces attention; MoE MLPs
      are untouched and out of scope per SURVEY.md §2.6).
    * Mistral sliding-window attention is disabled, matching the
      reference's config normalization (duo_attn/utils.py:102-104).
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling = RopeScaling()
    # High-precision RoPE phase computation (ops/rope.rope_cos_sin_precise).
    # Plain f32 angle = pos * inv_freq carries ~pos * 2^-23 rad of rounding
    # error — ~0.5 rad at 4M tokens for the fastest pair, which scrambles
    # high-frequency channels. TPUs have no fast f64, so the precise mode
    # range-reduces with a split-position product (error ~5e-4 rad at 4M,
    # position-independent). Negligible cost (elementwise, XLA-fused); off
    # by default so short-context numerics stay bit-identical.
    rope_precise: bool = False
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    model_type: str = "llama"
    # Mixtral MoE (0 experts = dense MLP). The reference's attention-only
    # patch leaves HF's MoE MLP intact (duo_attn/patch/__init__.py:44);
    # here the MoE MLP is part of the functional model (models/llama._mlp
    # routes on these fields).
    num_local_experts: int = 0
    num_experts_per_tok: int = 2

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0
        assert self.hidden_size == self.num_heads * self.head_dim or True


@dataclasses.dataclass(frozen=True)
class DuoConfig:
    """DuoAttention deployment config.

    Mirrors the knobs of ``enable_duo_attention_eval`` plus the cache sizing
    of ``DuoAttentionStaticKVCache`` (reference: duo_attn/patch/__init__.py:58-82,
    duo_attn/patch/static_kv_cache.py:18-99).

    ``num_full_kv_heads``: per-layer count of retrieval (full-attention) KV
    heads after reordering — full heads always occupy the leading contiguous
    slice of the KV-head axis, exactly like the reference's weight reordering
    (duo_attn/patch/utils.py:6-45).
    """

    sink_size: int = 64
    recent_size: int = 256
    num_full_kv_heads: Tuple[int, ...] = ()

    # Cache sizing (buffers are preallocated at these sizes).
    max_cache_size: int = 32768
    prefill_chunk_size: int = 8192

    def __post_init__(self):
        # The INT4 cache packs token pairs into nibble-interleaved bytes
        # (cache.write_full_q4); every prefill chunk after the first lands
        # at start = k * prefill_chunk_size, which must stay even or the
        # pair parity is silently lost. Enforce statically for all paths
        # (a chunk size this small would never be odd intentionally).
        assert self.prefill_chunk_size % 2 == 0, (
            f"prefill_chunk_size must be even (int4 token-pair packing), "
            f"got {self.prefill_chunk_size}"
        )

    @property
    def streaming_window(self) -> int:
        return self.sink_size + self.recent_size

    @property
    def streaming_buf_size(self) -> int:
        # The streaming buffer must absorb sink+recent plus one incoming
        # prefill chunk between compressions (reference sizing:
        # demo/int4_kv.py:166-181, duo_attn/patch/static_kv_cache.py:177-183).
        return self.sink_size + self.recent_size + self.prefill_chunk_size

    def num_streaming_kv_heads(self, cfg: ModelConfig) -> Tuple[int, ...]:
        return tuple(cfg.num_kv_heads - f for f in self.num_full_kv_heads)


# ---------------------------------------------------------------------------
# Model presets matching the reference's released patterns (attn_patterns/*)
# ---------------------------------------------------------------------------

LLAMA2_7B_32K = ModelConfig(  # togethercomputer/Llama-2-7B-32K-Instruct
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    rope_theta=10000.0,
    rope_scaling=RopeScaling(rope_type="linear", factor=8.0),
    max_position_embeddings=32768,
    model_type="llama",
)

LLAMA3_8B_1048K = ModelConfig(  # gradientai/Llama-3-8B-Instruct-Gradient-1048k
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=3580165449.0,
    max_position_embeddings=1048576,
    model_type="llama",
)

LLAMA3_8B_4194K = dataclasses.replace(
    LLAMA3_8B_1048K,
    rope_theta=53125398085.0,
    max_position_embeddings=4194304,
)

LLAMA31_8B = ModelConfig(  # meta-llama/Meta-Llama-3.1-8B-Instruct
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(
        rope_type="llama3",
        factor=8.0,
        low_freq_factor=1.0,
        high_freq_factor=4.0,
        original_max_position_embeddings=8192,
    ),
    max_position_embeddings=131072,
    model_type="llama",
)

MISTRAL_7B_V02 = ModelConfig(  # mistralai/Mistral-7B-Instruct-v0.2
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    model_type="mistral",
)

TINY_LLAMA = ModelConfig(  # tiny config for tests
    vocab_size=512,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=10000.0,
    max_position_embeddings=2048,
    model_type="llama",
)

TINY_GQA = ModelConfig(  # GQA tiny config
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=3,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    rope_theta=10000.0,
    max_position_embeddings=4096,
    model_type="mistral",
)

PRESETS = {
    "Llama-2-7B-32K-Instruct": LLAMA2_7B_32K,
    "Llama-3-8B-Instruct-Gradient-1048k": LLAMA3_8B_1048K,
    "Llama-3-8B-Instruct-Gradient-4194k": LLAMA3_8B_4194K,
    "Meta-Llama-3.1-8B-Instruct": LLAMA31_8B,
    "Mistral-7B-Instruct-v0.2": MISTRAL_7B_V02,
    "Mistral-7B-Instruct-v0.3": dataclasses.replace(MISTRAL_7B_V02, vocab_size=32768),
    "tiny-llama": TINY_LLAMA,
    "tiny-gqa": TINY_GQA,
    # smallest MHA config whose 8 KV heads divide an sp=8 Ulysses mesh —
    # used by the long-context sequence-parallel training demonstration
    # (scripts/train_scaled_cpu.sh)
    "tiny-sp8": ModelConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        rope_theta=10000.0,
        max_position_embeddings=32768,
    ),
}


def config_from_hf_dict(d: dict) -> ModelConfig:
    """Build a ModelConfig from a HuggingFace config.json dict."""
    rope_scaling = RopeScaling()
    rs = d.get("rope_scaling")
    if rs:
        rope_scaling = RopeScaling(
            rope_type=rs.get("rope_type", rs.get("type", "default")),
            factor=rs.get("factor", 1.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings", 8192
            ),
        )
    num_heads = d["num_attention_heads"]
    return ModelConfig(
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=d.get("num_key_value_heads", num_heads),
        head_dim=d.get("head_dim", d["hidden_size"] // num_heads),
        rope_theta=d.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        max_position_embeddings=d.get("max_position_embeddings", 4096),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        attention_bias=d.get("attention_bias", False),
        model_type=d.get("model_type", "llama"),
        num_local_experts=d.get("num_local_experts", 0),
        num_experts_per_tok=d.get("num_experts_per_tok", 2),
    )


def load_hf_config(path: str) -> ModelConfig:
    with open(path) as f:
        return config_from_hf_dict(json.load(f))
