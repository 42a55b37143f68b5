"""The port's gate training against the JAX package's, on the CPU.

Blockwise attention (values and q/k/v gradients), the W8A8 linear's
straight-through backward, the two-way forward and its gate gradient (float32
and W8A8; gates on the clip's bounds), the mirrors of tests/test_train.py
(gates = 1, gates = 0, remat), the losses, the schedule, AdamW against
optax.adamw, ``GateTrainer`` steps, its checkpoint files and a resume from a
checkpoint the JAX trainer wrote. Inputs and weights come from a numpy seed
and feed both packages (``models/from_jax.py`` carries the params across).
Tolerances: float32 values rtol 1e-5 (atol 1e-6 for values near 0; 1e-5
for the model's hidden states);
gradients and gates atol 1e-5; W8A8 under the flip bounds of
tests/test_torch_quant.py with at least one input tight.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from duo_attention_tpu import config as jconfig
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu.ops import blockwise as jblockwise
from duo_attention_tpu.ops import quant as jquant
from duo_attention_tpu.train import loss as jloss
from duo_attention_tpu.train import trainer as jtrainer
from duo_attention_tpu_torch import config as tconfig
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.ops import blockwise, quant
from duo_attention_tpu_torch.ops.attention_ref import masked_attention
from duo_attention_tpu_torch.ops.norm import rms_norm
from duo_attention_tpu_torch.ops.rope import apply_rope, rope_tables
from duo_attention_tpu_torch.train import loss as tloss
from duo_attention_tpu_torch.train import trainer as ttrainer
from duo_attention_tpu_torch.train.data import IGNORE_INDEX
from test_torch_model import numpy_params
from test_torch_quant import FLIP_REL_FRO, rel_fro

# One intra-op thread: the tensors are tiny, and the xdist workers that run
# these tests also run JAX's CPU thread pools.
torch.set_num_threads(1)
RTOL, VAL_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
# hidden states after three layers (O(1) after the final norm): the packages'
# float32 products sum in other orders, a few 1e-6 apart
HIDDEN_ATOL = 1e-5
# The STE backward rounds g * w_scale to bf16: where the forward values agree
# to float32 rounding, a last-bit difference still flips some of those bf16
# roundings, so the W8A8 gate gradients agree to bf16's precision (2^-8
# relative; seen: 2e-4 to 3e-4), not to float32's.
STE_GRAD_REL = 2.0**-8
SINK, RECENT, BLOCK = 8, 16, 32
CFG_NAME = "tiny-gqa"  # 3 layers, 8 query heads over 4 KV heads, head_dim 32


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# ops/blockwise.py
# ---------------------------------------------------------------------------

BLOCKWISE_CASES = {
    # name: (mask, B, Sq, Skv, Hq, Hkv, q_offset, k_offset, block_k)
    "causal": ("causal", 2, 100, 100, 4, 2, 0, 0, 32),
    "lambda": ("lambda", 1, 96, 96, 4, 4, 0, 0, 40),
    "causal_shard": ("causal", 1, 48, 112, 4, 2, 64, 0, 32),  # a query shard at 64 over all keys
    "lambda_offsets": ("lambda", 2, 40, 90, 8, 2, 50, 3, 64),  # ragged last block, both offsets
}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", sorted(BLOCKWISE_CASES))
def test_blockwise_matches_jax(case, remat):
    """Values (rtol 1e-5) and q/k/v gradients under a random cotangent (atol
    1e-5) against the JAX function; Skv is not a multiple of the block."""
    mask, B, Sq, Skv, Hq, Hkv, qo, ko, bk = BLOCKWISE_CASES[case]
    rng = np.random.default_rng(sorted(BLOCKWISE_CASES).index(case))
    D = 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    ct = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    jmask = jblockwise.causal_mask_fn if mask == "causal" else jblockwise.lambda_mask_fn(SINK, RECENT)
    tmask = blockwise.causal_mask_fn if mask == "causal" else blockwise.lambda_mask_fn(SINK, RECENT)
    jout, vjp = jax.vjp(lambda a, b, c: jblockwise.blockwise_attention(a, b, c, jmask, qo, ko, bk, remat),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    tout = blockwise.blockwise_attention(tq, tk, tv, tmask, qo, ko, bk, remat)
    (tout * t(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=VAL_ATOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GRAD_ATOL)


def test_blockwise_empty_rows_are_zero():
    """Queries with no visible key (keys all after them) give 0, as JAX's
    l == 0 -> 1 rule does."""
    rng = np.random.default_rng(3)
    q, k, v = (t(rng.standard_normal((1, 8, 2, 8)).astype(np.float32)) for _ in range(3))
    out = blockwise.blockwise_attention(q, k, v, blockwise.causal_mask_fn, q_offset=0, k_offset=8, block_k=4)
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# ops/quant.py: the W8A8 straight-through backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [(48,), (48, 16, 16), (64, 64)])
def test_w8a8_ste_matches_jax(ns, dtype):
    """Forward bitwise and dx bitwise against JAX's custom_vjp: one weight,
    and a group whose dx JAX sums over separate ``w8a8_linear`` calls (the
    port sums the terms in the same order in x's dtype)."""
    rng = np.random.default_rng(len(ns))
    K, M = 64, 24
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ws = [jquant.quantize_weight_int8(jnp.asarray(rng.standard_normal((K, n)).astype(np.float32) / 8)) for n in ns]
    x = rng.standard_normal((2, M // 2, K)).astype(np.float32)
    cts = [rng.standard_normal((2, M // 2, n)).astype(np.float32) for n in ns]
    xj = jnp.asarray(x).astype(jdt)

    def jfwd(a):
        return [jquant.w8a8_linear(a, wq, s, out_dtype=jdt) for wq, s in ws]

    jouts, vjp = jax.vjp(jfwd, xj)
    (jdx,) = vjp([jnp.asarray(c).astype(jdt) for c in cts])
    xt = t(x).to(tdt).requires_grad_(True)
    tw = [(t(wq).t().contiguous(), t(s)) for wq, s in ws]
    touts = quant.w8a8_linear_group(xt, tw, tdt) if len(ns) > 1 else (quant.w8a8_linear(xt, *tw[0], tdt),)
    torch.autograd.backward(touts, [t(c).to(tdt) for c in cts])
    for got, want in zip(touts, jouts):
        np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)))


def test_w8a8_ste_weights_get_no_gradient_and_forward_is_unchanged():
    """With a gradient the forward is the same function (bitwise), and the
    frozen int8 weights and scales get none."""
    rng = np.random.default_rng(0)
    wq, s = quant.quantize_weight_int8(t(rng.standard_normal((32, 64)).astype(np.float32)))
    s.requires_grad_(True)
    x = t(rng.standard_normal((5, 64)).astype(np.float32))
    plain = quant.w8a8_linear(x, wq, s, torch.float32)
    xg = x.clone().requires_grad_(True)
    out = quant.w8a8_linear(xg, wq, s, torch.float32)
    out.sum().backward()
    assert torch.equal(out.detach(), plain) and s.grad is None and xg.grad is not None


# ---------------------------------------------------------------------------
# models/llama.py: forward_two_way
# ---------------------------------------------------------------------------


def _models(seed=0, w8a8=False):
    """(port cfg, JAX cfg, port params, JAX params) of tiny-gqa from a numpy
    seed; with ``w8a8`` the projections quantized by the JAX package."""
    tcfg, jcfg = tconfig.PRESETS[CFG_NAME], jconfig.PRESETS[CFG_NAME]
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg, seed))
    if w8a8:
        jp = jquant.quantize_params_w8a8(jp)
    return tcfg, jcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu", torch.float32), jp


def _ids(cfg, S=64, seed=1, B=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@functools.lru_cache(maxsize=None)
def _jax_two_way_fn(jcfg, remat):
    def loss(g, jp, ids):
        tt, ss = jllama.forward_two_way(jp, g, jcfg, SINK, RECENT, ids, block_k=BLOCK, remat=remat)
        return jnp.mean((tt - ss) ** 2), (tt, ss)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _jax_two_way(jp, jcfg, gates, ids, remat=False):
    """JAX's (teacher, student) and the gate gradient of mean((t - s)^2)."""
    (_, (tt, ss)), g = _jax_two_way_fn(jcfg, remat)(jnp.asarray(gates), jp, jnp.asarray(ids))
    return np.asarray(tt), np.asarray(ss), np.asarray(g)


def _port_two_way(tp, tcfg, gates, ids, remat=False):
    g = t(gates).requires_grad_(True)
    tt, ss = tllama.forward_two_way(tp, g, tcfg, SINK, RECENT, torch.as_tensor(ids), block_k=BLOCK, remat=remat)
    ((tt - ss) ** 2).mean().backward()
    return tt.detach().numpy(), ss.detach().numpy(), g.grad.numpy()


def _gates(cfg, kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads)
    if kind == "inside":
        return rng.uniform(0.1, 0.9, shape).astype(np.float32)
    # a third each on 0, on 1 and inside: the clip's bounds carry half the gradient
    return rng.choice(np.array([0.0, 1.0, 0.3, 0.7], np.float32), shape)


@pytest.mark.parametrize("gates", ["inside", "bounds"])
def test_two_way_float32_matches_jax(gates):
    """Teacher, student (rtol 1e-5, atol 1e-5) and the gate gradient (atol
    1e-5) against jax.grad, float32."""
    tcfg, jcfg, tp, jp = _models()
    g = _gates(tcfg, gates)
    ids = _ids(tcfg)
    jt, js, jg = _jax_two_way(jp, jcfg, g, ids)
    tt, ts, tg = _port_two_way(tp, tcfg, g, ids)
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=HIDDEN_ATOL)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=HIDDEN_ATOL)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=GRAD_ATOL)
    assert np.abs(jg).max() > 100 * GRAD_ATOL


def test_gate_clip_has_jax_gradient_on_the_bounds(monkeypatch):
    """jnp.clip's gradient is 1/2 exactly on 0 and on 1 (lax.max and lax.min
    split a tie): the port's clip gives JAX's gate gradient there, and
    ``torch.clamp``, which passes the whole gradient, does not."""
    x = torch.tensor([-0.5, 0.0, 0.5, 1.0, 1.5], requires_grad=True)
    (tllama.clip_gates(x) * 3).sum().backward()
    want = jax.grad(lambda a: (jnp.clip(a, 0.0, 1.0) * 3).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.5, 3.0, 1.5, 0.0])

    tcfg, jcfg, tp, jp = _models()
    g = _gates(tcfg, "bounds")
    ids = _ids(tcfg)
    _, _, jg = _jax_two_way(jp, jcfg, g, ids)
    monkeypatch.setattr(tllama, "clip_gates", lambda a: torch.clamp(a, 0.0, 1.0))
    _, _, tg = _port_two_way(tp, tcfg, g, ids)
    on_bound = (g == 0.0) | (g == 1.0)
    assert np.abs(tg - jg)[on_bound].max() > 100 * GRAD_ATOL  # clamp doubles them
    np.testing.assert_allclose(tg[on_bound], 2 * jg[on_bound], rtol=1e-4, atol=GRAD_ATOL)


def test_two_way_w8a8_matches_jax():
    """W8A8 projections (JAX-quantized; the STE backward): teacher, student
    and gate gradient within the flip bounds for every input, and at least
    one of eight inputs of 32 tokens tight (values atol 1e-5, the gradient
    within STE_GRAD_REL; about half are); per-layer remat on, as the trainer
    runs it."""
    tcfg, jcfg, tp, jp = _models(w8a8=True)
    g = _gates(tcfg, "bounds", seed=1)
    tight = 0
    for seed in range(8):
        ids = _ids(tcfg, S=32, seed=10 + seed)
        jt, js, jg = _jax_two_way(jp, jcfg, g, ids, remat=True)
        tt, ts, tg = _port_two_way(tp, tcfg, g, ids, remat=True)
        assert rel_fro(tt, jt) <= FLIP_REL_FRO and rel_fro(ts, js) <= FLIP_REL_FRO and rel_fro(tg, jg) <= FLIP_REL_FRO
        tight += (np.abs(tt - jt).max() <= HIDDEN_ATOL and np.abs(ts - js).max() <= HIDDEN_ATOL
                  and rel_fro(tg, jg) <= STE_GRAD_REL)
    assert tight >= 1


def test_two_way_gates_one_teacher_equals_student():
    tcfg, _, tp, _ = _models()
    gates = torch.ones((tcfg.num_layers, tcfg.num_kv_heads))
    tt, ts = tllama.forward_two_way(tp, gates, tcfg, SINK, RECENT, torch.as_tensor(_ids(tcfg)), block_k=BLOCK)
    np.testing.assert_allclose(ts.numpy(), tt.numpy(), rtol=RTOL, atol=HIDDEN_ATOL)


def test_two_way_gates_zero_is_pure_streaming():
    """gates = 0: the student is a plain forward with Λ attention in every
    layer (the port's masked_attention oracle)."""
    tcfg, _, tp, _ = _models()
    ids = torch.as_tensor(_ids(tcfg))
    gates = torch.zeros((tcfg.num_layers, tcfg.num_kv_heads))
    _, ts = tllama.forward_two_way(tp, gates, tcfg, SINK, RECENT, ids, block_k=BLOCK)
    B, S = ids.shape
    cos, sin = rope_tables(tcfg, torch.arange(S, dtype=torch.int32))
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    lam = ((j <= i) & ((j < SINK) | (j >= i - RECENT + 1)))[None, None]
    x = tllama.embed_lookup(tp, ids)
    for layer in tp["layers"]:
        q, k, v = tllama._qkv(layer, rms_norm(x, layer["input_norm"], tcfg.rms_norm_eps), tcfg)
        attn = masked_attention(apply_rope(q, cos[None], sin[None]), apply_rope(k, cos[None], sin[None]), v, lam)
        x = x + tllama._proj(layer, attn.reshape(B, S, -1), "wo")
        x = x + tllama._mlp(layer, rms_norm(x, layer["post_norm"], tcfg.rms_norm_eps), tcfg)
    want = rms_norm(x, tp["final_norm"], tcfg.rms_norm_eps)
    np.testing.assert_allclose(ts.numpy(), want.numpy(), rtol=RTOL, atol=HIDDEN_ATOL)


@pytest.mark.parametrize("w8a8", [False, True])
def test_two_way_remat_matches_no_remat(w8a8):
    """Per-layer checkpointing changes memory, not math: teacher, student and
    the gate gradient are bitwise the same, also through the W8A8 STE."""
    tcfg, _, tp, _ = _models(w8a8=w8a8)
    g = _gates(tcfg, "bounds", seed=2)
    ids = _ids(tcfg, seed=5)
    runs = [_port_two_way(tp, tcfg, g, ids, remat) for remat in (False, True)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert np.abs(runs[1][2]).max() > 0


def test_two_way_parallel_options_raise():
    """The parallel options of forward_two_way (they raised until the
    parallel layouts were ported; what still raises is a seq axis that does
    not divide the heads). A layer hook is called at the top of every layer
    and, with remat, once more inside each student block's forward and
    recompute; an identity hook and a seq axis of one rank change nothing.
    The cross-rank cases are tests/test_torch_train_parallel.py's."""
    from duo_attention_tpu_torch.parallel.mesh import Axis

    tcfg, _, tp, _ = _models()
    g = _gates(tcfg, "inside", seed=3)
    ids = _ids(tcfg)
    want = _port_two_way(tp, tcfg, g, ids, remat=True)
    calls = []

    def hook(layer, deps):
        calls.append(len(calls))
        return layer, deps

    one = Axis("seq", 1, 0, None, None)
    gt = t(g).requires_grad_(True)
    tt, ss = tllama.forward_two_way(tp, gt, tcfg, SINK, RECENT, torch.as_tensor(ids), seq_axis=one,
                                    block_k=BLOCK, layer_hook=hook, remat=True)
    ((tt - ss) ** 2).mean().backward()
    for a, b in zip((tt.detach().numpy(), ss.detach().numpy(), gt.grad.numpy()), want):
        np.testing.assert_array_equal(a, b)
    assert len(calls) == 3 * tcfg.num_layers  # teacher, student forward, student recompute
    with pytest.raises(ValueError, match="divisible by 3"):
        tllama.forward_two_way(tp, t(g), tcfg, SINK, RECENT, torch.as_tensor(ids), seq_axis=Axis("seq", 3, 0, None, None))


def test_head_and_all_logits_match_jax():
    tcfg, _, tp, jp = _models()
    h = np.random.default_rng(4).standard_normal((2, 5, tcfg.hidden_size)).astype(np.float32)
    want = np.asarray(jllama.head_logits(jp, jnp.asarray(h)))
    for fn in (tllama.head_logits, tllama.all_logits):
        got = fn(tp, t(h))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=VAL_ATOL)


# ---------------------------------------------------------------------------
# train/loss.py, the schedule and the optimizer
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    th, sh = (rng.standard_normal((2, 16, 32)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 16)) < 0.3
    gates = rng.uniform(-0.1, 1.0, (3, 4)).astype(np.float32)
    np.testing.assert_allclose(float(tloss.distill_loss(t(th), t(sh), t(mask))),
                               float(jloss.distill_loss(jnp.asarray(th), jnp.asarray(sh), jnp.asarray(mask))),
                               rtol=RTOL)
    assert float(tloss.distill_loss(t(th), t(sh), torch.zeros(2, 16, dtype=torch.bool))) == 0.0
    np.testing.assert_allclose(float(tloss.l1_loss(t(gates))), float(jloss.l1_loss(jnp.asarray(gates))), rtol=RTOL)
    # over mesh axes of one rank each (no collective) it is the same value (cross-rank sums:
    # tests/test_torch_train_parallel.py)
    from duo_attention_tpu_torch.parallel.mesh import Axis

    axes = (Axis("data", 1, 0, None, None), Axis("seq", 1, 0, None, None))
    assert float(tloss.distill_loss(t(th), t(sh), t(mask), axis_names=axes)) == float(
        tloss.distill_loss(t(th), t(sh), t(mask)))


@pytest.mark.parametrize("warmup,num_steps", [(4, 40), (20, 300), (0, 5), (10, 10)])
def test_lr_schedule_matches_jax_at_every_step(warmup, num_steps):
    kw = dict(lr=0.05, warmup_steps=warmup, num_steps=num_steps)
    tfn = ttrainer.lr_schedule(ttrainer.GateTrainConfig(**kw))
    jfn = jtrainer.lr_schedule(jtrainer.GateTrainConfig(**kw))
    for step in range(num_steps + 3):
        assert tfn(step) == float(jfn(jnp.asarray(step, jnp.int32))), step


def test_adamw_matches_optax_over_scheduled_steps():
    """torch.optim.AdamW with optax's constants and the schedule at the
    count before the update, against optax.adamw(lr_schedule): 10 steps of
    random gradients, gates clamped after each (atol 1e-5: the two round
    the update's terms in other orders, ~1.5e-7 a step)."""
    cfg = ttrainer.GateTrainConfig(lr=0.05, warmup_steps=3, num_steps=10)
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((10, 3, 4)).astype(np.float32)
    opt = optax.adamw(learning_rate=jtrainer.lr_schedule(jtrainer.GateTrainConfig(**dataclasses.asdict(cfg))))
    jg = jnp.full((3, 4), 0.9, jnp.float32)
    state = opt.init(jg)
    trainer_like = ttrainer.GateTrainer.__new__(ttrainer.GateTrainer)  # only the optimizer plumbing
    trainer_like.gates = torch.full((3, 4), 0.9, requires_grad=True)
    trainer_like.optimizer = torch.optim.AdamW([trainer_like.gates], lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=ttrainer.WEIGHT_DECAY, foreach=False)
    trainer_like._set_opt_state(0, torch.zeros(3, 4), torch.zeros(3, 4))
    sched = ttrainer.lr_schedule(cfg)
    for i, g in enumerate(grads):
        updates, state = opt.update(jnp.asarray(g), state, jg)
        jg = jnp.clip(optax.apply_updates(jg, updates), 0.0, 1.0)
        trainer_like.gates.grad = t(g)
        trainer_like.optimizer.param_groups[0]["lr"] = sched(i)
        trainer_like.optimizer.step()
        with torch.no_grad():
            trainer_like.gates.clamp_(0.0, 1.0)
        np.testing.assert_allclose(trainer_like.gates.detach().numpy(), np.asarray(jg), rtol=0, atol=GRAD_ATOL)
    count, mu, nu = trainer_like._opt_state()
    assert count == int(state[0].count) == 10
    np.testing.assert_allclose(mu.numpy(), np.asarray(state[0].mu), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(nu.numpy(), np.asarray(state[0].nu), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# train/trainer.py: GateTrainer against the JAX trainer
# ---------------------------------------------------------------------------


def _batches(cfg, n, seed=0, B=1, S=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        out.append((ids, np.where(rng.uniform(size=ids.shape) < 0.2, ids, IGNORE_INDEX)))
    return out


def _tcfg(module, out_dir, **kw):
    return module.GateTrainConfig(**{**dict(lr=0.05, num_steps=6, warmup_steps=2, sink_size=SINK, recent_size=RECENT,
                                            save_steps=2, output_dir=str(out_dir), block_k=BLOCK), **kw})


def test_trainer_steps_match_jax(tmp_path):
    """Five GateTrainer steps on the same batches: the losses (rtol 1e-5)
    and the gates after each step (atol 1e-5)."""
    tcfg, jcfg, tp, jp = _models()
    jt = jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, tmp_path / "jax"))
    tt = ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path / "port"), device="cpu")
    for ids, labels in _batches(tcfg, 5):
        jl = jt.train_step(ids, labels)
        tl = tt.train_step(ids, labels)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(tt.gates_numpy(), np.asarray(jt.gates), rtol=0, atol=GRAD_ATOL)
    assert 0.0 < tt.gates_numpy().min() < 1.0 and tt.step_idx == jt.step_idx == 5


def test_checkpoint_files_match_jax(tmp_path):
    """save() and finalize() write JAX's files: the TSVs and config.json byte
    for byte from the same gates, and the npz with JAX's keys, dtypes and
    shapes (its optimizer state within 1e-5)."""
    tcfg, jcfg, tp, jp = _models()
    out = tmp_path / "run"
    trainers = {"jax": jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, out)),
                "port": ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, out), device="cpu")}
    files = {}
    for name, tr in trainers.items():
        for ids, labels in _batches(tcfg, 2):
            tr.train_step(ids, labels)
        if name == "port":  # the same gate values, so the text files can be compared byte for byte
            with torch.no_grad():
                tr.gates.copy_(t(np.asarray(trainers["jax"].gates)))
        tr.save()
        tr.finalize()
        files[name] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        for f in os.listdir(out):
            os.remove(out / f)
    assert sorted(files["jax"]) == sorted(files["port"])
    for f in files["jax"]:
        if f.endswith((".tsv", ".json")):
            assert files["port"][f] == files["jax"][f], f
    assert json.loads(files["port"]["config.json"])["sink_size"] == SINK
    for f in ("opt_state_step=2.npz", "opt_state_latest.npz"):
        jd, td = (np.load(__import__("io").BytesIO(files[k][f])) for k in ("jax", "port"))
        assert sorted(jd.files) == sorted(td.files) == ["arr_0", "arr_1", "arr_2", "arr_3", "gates", "step"]
        for k in jd.files:
            assert (jd[k].dtype, jd[k].shape) == (td[k].dtype, td[k].shape), k
            np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=GRAD_ATOL)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX trainer runs 3 steps and saves; the port resumes its
    opt_state_latest.npz and continues 2 steps to JAX's gates (atol 1e-5),
    as JAX's own trainer does from the same file."""
    tcfg, jcfg, tp, jp = _models()
    batches = _batches(tcfg, 5, seed=3)
    out = tmp_path / "run"
    first = jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, out))
    for ids, labels in batches[:3]:
        first.train_step(ids, labels)
    first.save()
    jt = jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, out))
    tt = ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, out), device="cpu")
    assert jt.resume() and tt.resume() and tt.step_idx == jt.step_idx == 3
    np.testing.assert_array_equal(tt.gates_numpy(), np.asarray(first.gates))
    for ids, labels in batches[3:]:
        jt.train_step(ids, labels)
        tt.train_step(ids, labels)
    np.testing.assert_allclose(tt.gates_numpy(), np.asarray(jt.gates), rtol=0, atol=GRAD_ATOL)
    # and JAX resumes the port's checkpoint
    tt.save()
    back = jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, out))
    assert back.resume() and back.step_idx == 5
    np.testing.assert_array_equal(np.asarray(back.gates), tt.gates_numpy())
    np.testing.assert_array_equal(np.asarray(back.opt_state[0].mu), tt._opt_state()[1].numpy())


def test_trainer_rejects_what_it_does_not_run(tmp_path):
    """dp or sp above 1 needs the rank's (data, seq) mesh, so without one it
    raises; FSDP without a mesh is one device (as JAX, which shards only on a
    mesh); params on another device than the trainer's raise."""
    tcfg, _, tp, _ = _models()
    for kw in ({"dp": 2}, {"sp": 2}, {"dp": 0}):
        with pytest.raises(ValueError, match="needs this rank's|at least 1"):
            ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path, **kw), device="cpu")
    assert ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path, fsdp=True), device="cpu").layer_hook is None
    with pytest.raises(ValueError, match="params are on"):
        ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path), device="meta")


def test_trainer_main_flags(tmp_path, monkeypatch):
    """The CLI: a short run on the CPU writes the artifact, on one process
    and on a (data 1, seq 2) mesh with FSDP; a size below 1 and a missing
    wandb raise before any model is built."""
    out = tmp_path / "cli"
    ttrainer.main(["--model", "tiny-llama", "--num-steps", "2", "--sink", "8", "--recent", "16", "--context-min",
                   "64", "--context-max", "96", "--num-passkeys", "1", "--pad-to", "128", "--block-k", "64",
                   "--save-steps", "1", "--output-dir", str(out), "--device", "cpu"])
    assert (out / "full_attention_heads.tsv").exists() and (out / "opt_state_step=2.npz").exists()
    # --sp 2 --fsdp: two gloo ranks; rank 0 writes the same artifact
    out_sp = tmp_path / "cli_sp"
    gates = ttrainer.main(["--model", "tiny-llama", "--num-steps", "2", "--sink", "8", "--recent", "16",
                           "--context-min", "64", "--context-max", "96", "--num-passkeys", "1", "--pad-to", "256",
                           "--block-k", "64", "--save-steps", "1", "--output-dir", str(out_sp), "--device", "cpu",
                           "--sp", "2", "--fsdp"])
    assert gates.shape == (2, 2) and np.isfinite(gates).all()
    assert (out_sp / "full_attention_heads.tsv").exists() and (out_sp / "opt_state_step=2.npz").exists()
    with pytest.raises(SystemExit, match="at least 1"):
        ttrainer.main(["--dp", "0", "--device", "cpu"])
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        ttrainer.main(["--wandb", "--device", "cpu"])
