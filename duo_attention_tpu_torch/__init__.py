"""duo_attention_tpu_torch — the PyTorch/CUDA port of duo_attention_tpu.

Runs DuoAttention's main path (chunked prefill, then greedy decode over the
retrieval/streaming split KV cache) on an NVIDIA H100, in bf16 and in the
W8A8KV4 serving format (int8 linears, INT4 full-head cache), with the
attention, cache-write and int8 matrix-product kernels hand-written in CUDA
(``csrc/``, built with nvcc at first use). The JAX package ``duo_attention_tpu`` stays the
reference; this package imports none of it.

Quick start (the card by default; pass device="cpu" for the plain PyTorch
path on the CPU):

    from duo_attention_tpu_torch import (
        PRESETS, DuoConfig, DuoEngine, init_params, load_attn_pattern,
        num_full_kv_heads_per_layer, sparsify_attention_heads,
    )
    heads, sink, recent = load_attn_pattern(pattern_dir)
    heads, _ = sparsify_attention_heads(heads, sparsity=0.5)
    cfg = PRESETS["Llama-3-8B-Instruct-Gradient-1048k"]
    duo = DuoConfig(sink_size=sink, recent_size=recent,
                    num_full_kv_heads=num_full_kv_heads_per_layer(heads),
                    max_cache_size=32768, prefill_chunk_size=4096)
    params = init_params(cfg, seed=0, device="cuda")
    engine = DuoEngine(params, cfg, duo, device="cuda")
    tokens, cache = engine.generate(input_ids, max_new_tokens=64)

W8A8KV4: ``params = init_params_w8a8(cfg, seed=0, quantize_embeds=True)``
(or ``init_params_w8a8_random``) and ``DuoEngine(..., kv_quant="int4")``.
"""

from .cache import DuoCache, DuoCacheQ4, init_cache, init_cache_q4, kv_memory_bytes
from .config import PRESETS, DuoConfig, ModelConfig, RopeScaling
from .engine import DuoEngine
from .models.llama import init_params
from .ops.quant import init_params_w8a8, init_params_w8a8_random
from .patterns import (
    load_attn_pattern,
    num_full_kv_heads_per_layer,
    save_attn_pattern,
    sparsify_attention_heads,
)

__version__ = "0.1.0"

__all__ = [
    "DuoConfig",
    "ModelConfig",
    "RopeScaling",
    "PRESETS",
    "load_attn_pattern",
    "save_attn_pattern",
    "sparsify_attention_heads",
    "num_full_kv_heads_per_layer",
    "DuoCache",
    "DuoCacheQ4",
    "init_cache",
    "init_cache_q4",
    "kv_memory_bytes",
    "DuoEngine",
    "init_params",
    "init_params_w8a8",
    "init_params_w8a8_random",
]
