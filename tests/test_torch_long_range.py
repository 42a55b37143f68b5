"""The long-range circuit (LONG_SPEC: head_dim 64, RoPE theta 1e14, precise
RoPE) retrieving through the port's engine, against the JAX package's test.

Counterpart of tests/test_long_range.py::test_long_circuit_retrieves_through_engine:
with the ground-truth duo pattern (layer 1, heads 0 and 1) every passkey of
four samples is generated exactly, and with the inverted pattern (same budget,
the wrong heads) retrieval collapses, in float32 and in W8A8KV4 on the CPU.
The ``cuda`` cases run the same through the card's head_dim-64 kernels, in
bf16 as ``run_loop`` casts the circuit there; they skip without a GPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from duo_attention_tpu_torch.evals.accuracy_loop import _cast_floats, build_engine, eval_retrieval
from duo_attention_tpu_torch.models.constructed import LONG_SPEC, build_params
from duo_attention_tpu_torch.tokenizer import get_tokenizer
from duo_attention_tpu_torch.train.data import MultiPasskeyDataset, PasskeyDataConfig

torch.set_num_threads(2)
CFG_LONG = LONG_SPEC.model_config()
GT = np.zeros((2, 4))
GT[1, :2] = 1.0  # layer-1 heads 0/1 are the known retrieval heads


def test_long_spec_matches_jax():
    """The port's LONG_SPEC is JAX's: head_dim 64, theta 1e14, precise RoPE.
    (JAX is imported here, not above: the card's machine runs this file's
    ``cuda`` cases without it.)"""
    from duo_attention_tpu.models.constructed import LONG_SPEC as J_LONG_SPEC

    assert dataclasses.asdict(LONG_SPEC) == dataclasses.asdict(J_LONG_SPEC)
    assert CFG_LONG.head_dim == 64 and CFG_LONG.rope_theta == 1e14 and CFG_LONG.rope_precise


def _bits(device):
    tok = get_tokenizer("word")
    params = build_params(tok, spec=LONG_SPEC, device=device)
    dcfg = PasskeyDataConfig(context_length_min=768, context_length_max=1024, num_passkeys=2, passkey_length=3)
    return tok, params, MultiPasskeyDataset(tok, dcfg, num_samples=100_000)


@pytest.fixture(scope="module")
def cpu_bits():
    return _bits("cpu")


def _retrieves(tok, params, ds, quant, device, dtype):
    kw = {"w8a8": True, "kv_quant": "int4"} if quant else {}
    eng = build_engine(params, CFG_LONG, GT, sink=16, recent=64, max_cache=4096, chunk=512, dtype=dtype,
                       device=device, **kw)
    r = eval_retrieval(eng, tok, ds, n_samples=4)
    assert r["word_overlap"] == 1.0, r
    eng = build_engine(params, CFG_LONG, 1.0 - GT, sink=16, recent=64, max_cache=4096, chunk=512, dtype=dtype,
                       device=device, **kw)
    r = eval_retrieval(eng, tok, ds, n_samples=4)
    assert r["word_overlap"] < 0.25, r


@pytest.mark.parametrize("quant", [False, True])
def test_long_circuit_retrieves_through_engine(cpu_bits, quant):
    _retrieves(*cpu_bits, quant, "cpu", torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_long_circuit_retrieves_through_the_head_dim_64_kernels(quant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from duo_attention_tpu_torch.ops import flash

    tok, params, ds = _bits("cuda")
    before = flash.full_cache_attention.prefill_launches + flash.full_cache_attention_q4.prefill_launches
    _retrieves(tok, _cast_floats(params, torch.bfloat16), ds, quant, "cuda", torch.bfloat16)
    assert flash.full_cache_attention.prefill_launches + flash.full_cache_attention_q4.prefill_launches > before
