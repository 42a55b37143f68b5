"""The port's constructed retrieval circuit against the JAX package's.

models/constructed.py builds the circuit in numpy and the port keeps its own
copy. Its params leave through models/from_jax.py's rules, so they must equal
the JAX params after ``params_from_numpy`` bit for bit: float32 for the
BASE, LONG and SMALL_D128 specs, and the int8 tables and float32 scales of
the W8A8 build (``build_params_w8a8``, the form the 8B graft runs in) at
SMALL_D128_SPEC, the CPU-sized twin of LONG_8B_SPEC's geometry. Its
pass-through layers must each own their buffers, as a real checkpoint's do.
All comparisons are exact (``torch.equal``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from duo_attention_tpu import config as jconfig
from duo_attention_tpu.models import constructed as jc
from duo_attention_tpu.models import convert as jconvert
from duo_attention_tpu.tokenizer import get_tokenizer as jget_tokenizer
from duo_attention_tpu_torch import config as tconfig
from duo_attention_tpu_torch.models import constructed as tc
from duo_attention_tpu_torch.models import convert as tconvert
from duo_attention_tpu_torch.models.from_jax import leaf_from_numpy
from duo_attention_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)
SPEC_NAMES = ["constructed", "constructed-long", "constructed-d128"]


def jax_as_port(jparams):
    """JAX params through models/from_jax.py's rules, each leaf in its own
    dtype (the W8A8 build's norms and biases are bf16, its float tables
    float32); bf16 goes through float32, which is exact."""
    def leaf(name, arr):
        arr = np.asarray(arr)
        bf16 = arr.dtype.name == "bfloat16"
        return leaf_from_numpy(name, arr.astype(np.float32) if bf16 else arr, "cpu",
                               torch.bfloat16 if bf16 else torch.float32)

    out = {k: leaf(k, v) for k, v in jparams.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in layer.items()} for layer in jparams["layers"]]
    return out


def assert_params_equal(got, want):
    assert set(got) == set(want)
    for name in got:
        if name == "layers":
            assert len(got[name]) == len(want[name])
            for li, (g, w) in enumerate(zip(got[name], want[name])):
                assert set(g) == set(w), li
                for k in g:
                    assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), (li, k)
        else:
            assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


def test_specs_and_configs_equal():
    assert tc.SPECS.keys() == jc.SPECS.keys()
    for name, spec in tc.SPECS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jc.SPECS[name]), name
        tcfg, jcfg = dataclasses.asdict(spec.model_config()), dataclasses.asdict(jc.SPECS[name].model_config())
        assert tcfg == jcfg, name
        np.testing.assert_array_equal(tc.ground_truth_heads(spec), jc.ground_truth_heads(jc.SPECS[name]))
    # the 8B graft is the flagship geometry
    ref = tconfig.PRESETS["Llama-3-8B-Instruct-Gradient-1048k"]
    cfg = tc.LONG_8B_SPEC.model_config()
    for field in ("num_layers", "hidden_size", "intermediate_size", "num_heads", "num_kv_heads", "head_dim",
                  "vocab_size"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert dataclasses.asdict(jconfig.PRESETS["Llama-3-8B-Instruct-Gradient-1048k"]) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_signatures_equal(name):
    spec = tc.SPECS[name]
    t = tc.Signatures(get_tokenizer("word"), num_digits=spec.num_digits)
    j = jc.Signatures(jget_tokenizer("word"), num_digits=spec.num_digits)
    assert (t.name_ids, t.code_ids, t.is_id, t.dot_id, t.digit_ids) == \
        (j.name_ids, j.code_ids, j.is_id, j.dot_id, j.digit_ids)
    for table in ("match", "out"):
        tm, jm = getattr(t, table), getattr(j, table)
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_array_equal(tm[k], jm[k])
    np.testing.assert_array_equal(t.bos_sig, j.bos_sig)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_build_params_f32_bitwise(name):
    got = tc.build_params(get_tokenizer("word"), spec=tc.SPECS[name], device="cpu")
    want = jax_as_port(jc.build_params(jget_tokenizer("word"), spec=jc.SPECS[name]))
    assert_params_equal(got, want)


@pytest.mark.parametrize("quantize_embeds", [True, False])
def test_build_params_w8a8_bitwise(quantize_embeds):
    spec = tc.SMALL_D128_SPEC
    got = tc.build_params_w8a8(get_tokenizer("word"), spec=spec, quantize_embeds=quantize_embeds, device="cpu")
    jparams = jc.build_params_w8a8(jget_tokenizer("word"), spec=jc.SMALL_D128_SPEC,
                                   quantize_embeds=quantize_embeds)
    assert_params_equal(got, jax_as_port(jparams))
    for layer in got["layers"]:
        assert layer["wq_q8"].dtype == torch.int8 and layer["wq_scale"].dtype == torch.float32
        assert layer["bq"].dtype == torch.bfloat16 and layer["input_norm"].dtype == torch.bfloat16


def test_passthrough_layers_own_their_buffers():
    spec = tc.SMALL_D128_SPEC
    params = tc.build_params_w8a8(get_tokenizer("word"), spec=spec, device="cpu")
    ptrs = [t.untyped_storage().data_ptr() for layer in params["layers"] for t in layer.values()]
    ptrs += [t.untyped_storage().data_ptr() for k, t in params.items() if k != "layers"]
    assert len(set(ptrs)) == len(ptrs)
    passthrough = [li for li in range(spec.num_layers) if li not in spec.circuit_layers]
    assert passthrough
    for li in passthrough:
        layer = params["layers"][li]
        assert not any(layer[k].any() for k in layer if k.endswith("_q8"))
        assert all(torch.equal(layer[k], torch.full_like(layer[k], 1e-12)) for k in layer if k.endswith("_scale"))


def test_q8_reorder_matches_jax():
    """The port's q8-aware reorder of the W8A8 build equals the JAX package's
    reorder of its own build, for the trained and the inverted pattern."""
    spec = tc.SMALL_D128_SPEC
    cfg, jcfg = spec.model_config(), jc.SMALL_D128_SPEC.model_config()
    got = tc.build_params_w8a8(get_tokenizer("word"), spec=spec, device="cpu")
    jparams = jc.build_params_w8a8(jget_tokenizer("word"), spec=jc.SMALL_D128_SPEC)
    gt = tc.ground_truth_heads(spec)
    for heads in (gt, 1.0 - gt):
        t_re, t_nf = tconvert.reorder_params(got, cfg, heads)
        j_re, j_nf = jconvert.reorder_params(jparams, jcfg, heads)
        assert t_nf == tuple(j_nf)
        assert_params_equal(t_re, jax_as_port(j_re))
