"""Fixtures of the benchmark's CPU tests: tiny configurations in the
configuration files' format, and a context that runs a driver on the CPU."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core.harness import Context  # noqa: E402

LIMITS = {"served_widest_gap": 1.0, "train_loss_gap": 0.05, "train_grad_gap": 0.05, "train_change_gap": 0.05}


def tiny_conf(moe: bool = False) -> dict:
    """tiny-gqa's sizes (PRESETS["tiny-gqa"]), or a tiny Mixtral (4 experts, top 2)."""
    conf = {"name": "tiny-moe" if moe else "tiny-gqa", "vocab_size": 512, "hidden_size": 256,
            "intermediate_size": 512, "num_hidden_layers": 3, "num_attention_heads": 8,
            "num_key_value_heads": 4, "head_dim": 32, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "max_position_embeddings": 4096, "model_type": "mixtral" if moe else "mistral",
            "duo": {"sink_size": 4, "recent_size": 16, "prefill_chunk_size": 64, "max_cache_size": 512,
                    "full_kv_heads": [[0, 2], [1], [0, 1, 2, 3]]},
            "limits": dict(LIMITS)}
    if moe:
        conf.update(num_local_experts=4, num_experts_per_tok=2)
    return conf


MIXES = {
    "closed": {"driver": "closed_loop", "clients": 3, "slots": 2, "decode_burst": 4,
               "prompt": {"dist": "loguniform", "min": 40, "max": 200}, "output": {"dist": "uniform", "min": 8, "max": 24},
               "trace_iterations": 3, "check": {"served_tokens": 40, "max_requests": 3}},
    "open": {"driver": "open_loop", "slots": 2, "decode_burst": 4, "rate_rps": 4.0, "warm_s": 0.5,
             "prompt": {"dist": "loguniform", "min": 40, "max": 200}, "output": {"dist": "uniform", "min": 8, "max": 24},
             "trace_iterations": 3, "check": {"served_tokens": 40, "max_requests": 3}},
    "train": {"driver": "gate_train", "data": {"context_length_min": 192, "context_length_max": 256, "intervals": 2,
                                               "num_passkeys": 2, "pad_to_multiple": 64},
              "initial_gates": [0.1, 0.9], "trace_steps": 1, "check": {"steps": 3}},
}


@pytest.fixture
def cpu_context(tmp_path):
    torch.manual_seed(0)
    torch.set_num_threads(4)

    def make(mix: str, moe: bool = False, seconds: float = 1.0, seed: int = 2**31 + 9):
        conf = tiny_conf(moe)
        return Context(root=ROOT, bench={}, cell={"name": conf["name"]}, conf=conf, mix=dict(MIXES[mix]),
                       limits=conf["limits"], seed=seed, seconds=seconds, trace=False, t_start=time.monotonic(),
                       out_dir=tmp_path, device=torch.device("cpu"))

    return make


@pytest.fixture
def card():
    """The card, for the tests that need one; they skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)
