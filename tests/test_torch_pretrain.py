"""The port's pretraining, the accuracy loop and gate training on the
constructed circuits, against the JAX package, on the CPU.

``lm_loss``, four ``pretrain`` steps (one of them a copy-curriculum batch),
``answer_token_accuracy``, the ``save_lm``/``load_lm`` round trip, a tiny
``run_loop`` whose ``report.json`` has the JAX loop's keys, and the mirror of
tests/test_graft_8b.py:141 (gate training on the W8A8 8B-graft twin finds
exactly the circuit's two retrieval heads). Inputs and weights come from a
numpy seed and feed both packages; tolerances are stated in each test.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duo_attention_tpu.models import constructed as jconstructed
from duo_attention_tpu.train import pretrain as jpretrain
from duo_attention_tpu.train.data import MultiPasskeyDataset as JDataset
from duo_attention_tpu.train.data import PasskeyDataConfig as JDataConfig
from duo_attention_tpu_torch.evals import accuracy_loop
from duo_attention_tpu_torch.models import constructed as tconstructed
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.tokenizer import get_tokenizer
from duo_attention_tpu_torch.train import pretrain as tpretrain
from duo_attention_tpu_torch.train import trainer as ttrainer
from duo_attention_tpu_torch.train.data import MultiPasskeyDataset, PasskeyDataConfig, data_iterator
from test_torch_model import numpy_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a 2-layer, 64-wide TINY_LM (the same model type, 4 query heads over 2 KV heads)
SMALL = dict(num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4, num_kv_heads=2, head_dim=16)
TCFG = dataclasses.replace(tpretrain.TINY_LM, **SMALL)
JCFG = dataclasses.replace(jpretrain.TINY_LM, **SMALL)


def _params(seed=0):
    tree = numpy_params(JCFG, seed)
    return params_from_numpy(tree, "cpu", torch.float32), jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(params):
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{i}.{k}": v for i, layer in enumerate(params["layers"]) for k, v in layer.items()})
    return out


def _batch(seed, B=2, S=96):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TCFG.vocab_size, (B, S))
    ids[:, -5:] = 0  # padding
    labels = np.where(rng.uniform(size=ids.shape) < 0.2, ids, -100)
    return ids, labels


def test_lm_loss_matches_jax():
    """Weighted next-token CE over the real positions, rtol 1e-5."""
    tp, jp = _params()
    ids, labels = _batch(0)
    for weight in (1.0, 10.0):
        got = float(tpretrain.lm_loss(tp, TCFG, torch.as_tensor(ids), torch.as_tensor(labels), answer_weight=weight))
        want = float(jpretrain.lm_loss(jp, JCFG, jnp.asarray(ids), jnp.asarray(labels), answer_weight=weight))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pretrain_steps_match_jax(monkeypatch):
    """Four steps from the same params on the same batches (step 3 is the
    copy curriculum's): the loss at each step (rtol 1e-5) and every param
    after them (atol 1e-5). Clipping and AdamW as optax's chain, the lr
    ramp evaluated before each update (the first update has lr 0)."""
    monkeypatch.setenv("DUO_JAX_CACHE_DIR", "off")
    tp, jp = _params(1)
    start = {k: v.clone() for k, v in _flat(tp).items()}
    tok = get_tokenizer("byte")
    kw = dict(context_length_min=64, context_length_max=96, num_passkeys=1, passkey_length=2)
    pkw = dict(num_steps=4, batch_size=2, log_every=1, warmup_steps=2)
    jparams, jlosses = jpretrain.pretrain(JCFG, jpretrain.PretrainConfig(**pkw), JDataConfig(**kw), tok, jp)
    tparams, tlosses = tpretrain.pretrain(TCFG, tpretrain.PretrainConfig(**pkw), PasskeyDataConfig(**kw), tok, tp,
                                          device="cpu")
    assert [i for i, _ in tlosses] == [i for i, _ in jlosses] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in tlosses], [v for _, v in jlosses], rtol=1e-5)
    want = _flat(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu", torch.float32))
    got = _flat(tparams)
    assert sorted(got) == sorted(want)
    for name, tensor in got.items():
        assert not tensor.requires_grad, name
        np.testing.assert_allclose(tensor.numpy(), want[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
    assert max(float((got[k] - start[k]).abs().max()) for k in got) > 1e-3  # the steps moved the params


def test_answer_token_accuracy_matches_jax():
    """The constructed circuit copies every answer (1.0 in both packages);
    random params give the same accuracy in both."""
    tok = get_tokenizer("word")
    dcfg = dict(context_length_min=128, context_length_max=256, num_passkeys=2, passkey_length=3)
    tds = MultiPasskeyDataset(tok, PasskeyDataConfig(**dcfg), num_samples=100_000)
    jds = JDataset(tok, JDataConfig(**dcfg), num_samples=100_000)
    tp = tconstructed.build_params(tok, device="cpu")
    jp = jconstructed.build_params(tok)
    cfg = tconstructed.CONSTRUCTED_LM
    assert tpretrain.answer_token_accuracy(tp, cfg, tds, n_samples=2, offset=50_000) == 1.0
    assert jpretrain.answer_token_accuracy(jp, jconstructed.CONSTRUCTED_LM, jds, n_samples=2, offset=50_000) == 1.0
    rp, rj = _params(2)
    got = tpretrain.answer_token_accuracy(rp, TCFG, tds, n_samples=2)
    want = jpretrain.answer_token_accuracy(rj, JCFG, jds, n_samples=2)
    assert got == want


def test_save_load_lm_round_trip(tmp_path):
    """save_lm then load_lm gives the same tensors bit for bit, and they
    compute JAX's lm_loss (rtol 1e-5)."""
    tp, jp = _params(3)
    path = str(tmp_path / "lm.npz")
    tpretrain.save_lm(tp, path)
    back = tpretrain.load_lm(path, TCFG, device="cpu")
    assert sorted(back) == sorted(tp)
    for got, want in zip(back["layers"], tp["layers"]):
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(back[k], tp[k]) for k in tp if k != "layers")
    ids, labels = _batch(4)
    np.testing.assert_allclose(
        float(tpretrain.lm_loss(back, TCFG, torch.as_tensor(ids), torch.as_tensor(labels))),
        float(jpretrain.lm_loss(jp, JCFG, jnp.asarray(ids), jnp.asarray(labels))), rtol=1e-5)


def _keys(obj):
    """The nested key structure of a JSON object (lists by their first item)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def test_run_loop_writes_jax_report(tmp_path):
    """A tiny loop on the constructed circuit (2 gate steps, 1 eval sample,
    both formats) writes report.json with the keys of the JAX loop's own
    record (artifacts/accuracy_loop/report.json) and JAX's model config; a
    second call reuses the pattern it wrote."""
    report = accuracy_loop.run_loop(str(tmp_path), gate_steps=2, eval_samples=1, ctx_min=128, ctx_max=256,
                                    batch_size=1, device="cpu")
    with open(os.path.join(REPO, "artifacts", "accuracy_loop", "report.json")) as f:
        record = json.load(f)
    with open(tmp_path / "report.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(report))
    # the record predates ModelConfig.rope_precise: its model config is held
    # to the JAX package's ModelConfig as it is now
    record.pop("model")
    assert _keys({k: v for k, v in written.items() if k != "model"}) == _keys(record)
    assert written["model"] == dataclasses.asdict(jconstructed.CONSTRUCTED_LM)
    assert np.asarray(written["gates"]).shape == (2, 4) and written["teacher_forced_answer_acc"] == 1.0
    assert written["results"]["full_attention"]["word_overlap"] == 1.0
    assert (tmp_path / "pattern" / "config.json").exists()
    again = accuracy_loop.run_loop(str(tmp_path), gate_steps=2, eval_samples=1, ctx_min=128, ctx_max=256,
                                   batch_size=1, quantized_eval=False, device="cpu")
    assert again["gates"] == written["gates"] and sorted(again["results"]) == [
        "full_attention", "inverted_pattern", "trained_pattern"]


def test_entry_points_default_to_the_card():
    """GateTrainer, pretrain, load_lm and run_loop run on the card unless
    asked for the CPU; without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tp, _ = _params()
    for call in (lambda: ttrainer.GateTrainer(tp, TCFG, ttrainer.GateTrainConfig(output_dir="unused")),
                 lambda: tpretrain.pretrain(TCFG, tpretrain.PretrainConfig(num_steps=1)),
                 lambda: tpretrain.load_lm("unused.npz", TCFG),
                 lambda: accuracy_loop.run_loop("unused")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.fixture
def four_threads():
    """Four intra-op threads for one test (about 1.6 s a step instead of 5)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(kept)


def test_gate_training_discovers_graft_heads(tmp_path, four_threads):
    """Mirror of tests/test_graft_8b.py:141: 40 steps of gate training on the
    W8A8 8B-graft twin (SMALL_D128_SPEC: the wide host, GQA and the STE)
    leave exactly the circuit's two retrieval heads above 0.5."""
    tok = get_tokenizer("word")
    spec = tconstructed.SMALL_D128_SPEC
    cfg = spec.model_config()
    params = tconstructed.build_params_w8a8(tok, spec=spec, device="cpu")
    tcfg = ttrainer.GateTrainConfig(lr=0.05, reg_weight=0.05, num_steps=40, warmup_steps=4, sink_size=16,
                                    recent_size=64, batch_size=2, save_steps=1000, block_k=256,
                                    output_dir=str(tmp_path))
    trainer = ttrainer.GateTrainer(params, cfg, tcfg, device="cpu")
    dcfg = PasskeyDataConfig(context_length_min=512, context_length_max=768, num_passkeys=2, passkey_length=3,
                             pad_to_multiple=64)
    trainer.train(data_iterator(MultiPasskeyDataset(tok, dcfg), 2, pad_to=768), log_every=50)
    g = trainer.gates_numpy()
    assert ((g > 0.5) == (tconstructed.ground_truth_heads(spec) > 0.5)).all(), g


def test_run_loop_on_the_card_needs_the_kernels_head_dim(monkeypatch):
    """The card's kernels take head_dim 64 as well as 128: run_loop no
    longer refuses the reference's 64-wide circuit there, and reaches its
    work (stopped at its first step here)."""

    class PastTheCheck(Exception):
        pass

    def stop(*a, **k):
        raise PastTheCheck

    monkeypatch.setattr(accuracy_loop, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(accuracy_loop.os, "makedirs", stop)
    with pytest.raises(PastTheCheck):
        accuracy_loop.run_loop("unused", lm="constructed")


def test_run_loop_default_circuit_follows_the_device(monkeypatch):
    """With no --lm, the CLI runs the reference's 64-wide constructed circuit
    on either device, as JAX's loop does."""
    import inspect

    assert inspect.signature(accuracy_loop.run_loop).parameters["lm"].default == "constructed"
    seen = {}

    def record(out_dir, **kw):
        seen.update(kw)
        return {"results": {}}

    monkeypatch.setattr(accuracy_loop, "run_loop", record)
    for device in ("cuda", "cpu"):
        accuracy_loop.main(["--out-dir", "unused", "--device", device])
        assert seen["lm"] == "constructed" and seen["device"] == device
