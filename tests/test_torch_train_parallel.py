"""Gate training's parallel layouts in the port (Ulysses, the (data, seq)
mesh, FSDP) against the JAX package, on the CPU.

Counterparts of tests/test_train.py's Ulysses tests and of
tests/test_fsdp.py, and of JAX's ``dryrun_train_step``. The port's ranks are
new processes (gloo, float32, one intra-op thread each) on one (data 2, seq
2) mesh spawned once for the module (``parallel.mesh.run_ranks`` with
``inner="seq"``, a ``file://`` store under ``tmp_path``; a rank that fails or
outlasts SPAWN_TIMEOUT_S fails the run); JAX runs its ``shard_map`` step on
4 of the 8 virtual CPU devices of tests/conftest.py.

JAX's sharded step takes N = dp x sp times its one-device gradient of the
distillation term (``duo_attention_tpu/train/loss.py:41-42`` differentiates
a psum inside ``shard_map``, ``trainer.py:140`` sums again); the port
reproduces the factor, and ``test_sharded_gradient_is_n_times_one_process``
pins it. Tolerances: hidden states atol 3e-4 (tests/test_train.py:219-241),
losses atol 1e-5 and gates atol 2e-5 (tests/test_fsdp.py), gradients 1e-5
relative to their largest entry.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from duo_attention_tpu.config import PRESETS as JPRESETS
from duo_attention_tpu.models import llama as jllama
from duo_attention_tpu.train import loss as jloss
from duo_attention_tpu.train import trainer as jtrainer
from duo_attention_tpu_torch.config import PRESETS as TPRESETS
from duo_attention_tpu_torch.models import llama as tllama
from duo_attention_tpu_torch.models.from_jax import params_from_numpy
from duo_attention_tpu_torch.parallel import fsdp
from duo_attention_tpu_torch.parallel import mesh as pmesh
from duo_attention_tpu_torch.parallel import ulysses
from duo_attention_tpu_torch.train import trainer as ttrainer
from duo_attention_tpu_torch.train.data import IGNORE_INDEX
from test_torch_model import numpy_params

torch.set_num_threads(1)
SPAWN_TIMEOUT_S = 240
DP, SP = 2, 2
N = DP * SP
SINK, RECENT, BLOCK = 8, 16, 32
B, S = 2, 128
HIDDEN_ATOL, LOSS_ATOL, GATES_ATOL, GRAD_REL = 3e-4, 1e-5, 2e-5, 1e-5


def _models(seed=0):
    """tiny-gqa (3 layers, 8 query heads over 4 KV heads, head_dim 32) from a
    numpy seed, float32: (port cfg, JAX cfg, port params, JAX params)."""
    jcfg, tcfg = JPRESETS["tiny-gqa"], TPRESETS["tiny-gqa"]
    tree = numpy_params(jcfg, seed)
    return tcfg, jcfg, params_from_numpy(tree, "cpu", torch.float32), jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.where(rng.uniform(size=ids.shape) < 0.2, ids, IGNORE_INDEX)
    return ids, labels


def _gates(cfg, value=0.6):
    return np.full((cfg.num_layers, cfg.num_kv_heads), value, np.float32)


def _shift(labels):
    return np.concatenate([labels[:, 1:], np.full((labels.shape[0], 1), IGNORE_INDEX, labels.dtype)], axis=1)


def _tcfg(module, out_dir, **kw):
    return module.GateTrainConfig(**{**dict(lr=0.05, num_steps=4, warmup_steps=1, sink_size=SINK, recent_size=RECENT,
                                            block_k=BLOCK, dp=DP, sp=SP, output_dir=str(out_dir)), **kw})


def job(fn, *args, **kwargs):
    return (fn, args, kwargs)


BATCHES = [_batch(TPRESETS["tiny-gqa"], 10 + i) for i in range(2)]
X = np.random.default_rng(3).standard_normal((2, 8, 4, 3)).astype(np.float32)
W = np.random.default_rng(4).standard_normal((2, 8, 4, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    return _models()


@pytest.fixture(scope="module")
def mesh_ds(tiny, tmp_path_factory):
    """One spawn of 4 ranks, (data 2, seq 2), running every test's jobs."""
    tcfg, _, tp, _ = tiny
    out = tmp_path_factory.mktemp("train_out")
    ids, labels = BATCHES[0]
    g = _gates(tcfg)
    grad_cfg = _tcfg(ttrainer, out / "grads", reg_weight=0.0)
    jobs = {
        "roundtrip": job(ulysses.roundtrip, X, W),
        "two_way": job(ttrainer.two_way_job, tp, tcfg, g, ids, _shift(labels), SINK, RECENT, BLOCK),
        "two_way_fsdp_remat": job(ttrainer.two_way_job, tp, tcfg, g, ids, _shift(labels), SINK, RECENT, BLOCK,
                                  fsdp=True, remat=True),
        "grads": job(ttrainer.steps_job, tp, tcfg, grad_cfg, BATCHES[:1], gates=g),
        "steps": job(ttrainer.steps_job, tp, tcfg, _tcfg(ttrainer, out / "repl"), BATCHES, gates=g, resume=True),
        "fsdp": job(ttrainer.steps_job, tp, tcfg, _tcfg(ttrainer, out / "fsdp", fsdp=True), BATCHES, gates=g),
        "fsdp_no_remat": job(ttrainer.steps_job, tp, tcfg, _tcfg(ttrainer, out / "fsdp_nr", fsdp=True, remat=False),
                             BATCHES, gates=g),
    }
    t0 = time.perf_counter()
    ranks = pmesh.run_ranks(pmesh.run_jobs, SP, DP, args=(list(jobs.values()),), device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S, store_dir=str(tmp_path_factory.mktemp("store_ds")),
                            inner="seq")
    return dict(ranks=[dict(zip(jobs, r)) for r in ranks], seconds=time.perf_counter() - t0, out=out)


def _assemble(ranks, key, field):
    """The global [B, S, ...] array from the ranks' (data, seq) shards."""
    rows = [np.concatenate([ranks[d * SP + s][key][field] for s in range(SP)], axis=1) for d in range(DP)]
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


def test_ulysses_roundtrip_and_its_backward(mesh_ds):
    """seq_to_head gives the rank's head shard of the whole sequence,
    head_to_seq brings back its sequence shard (the identity, bitwise), and
    the backward of seq_to_head is the inverse all_to_all."""
    Sl, Hl = X.shape[1] // SP, X.shape[2] // SP
    for rank, r in enumerate(mesh_ds["ranks"]):
        s = rank % SP
        y, z, grad = r["roundtrip"]
        np.testing.assert_array_equal(y, X[:, :, s * Hl : (s + 1) * Hl])
        np.testing.assert_array_equal(z, X[:, s * Sl : (s + 1) * Sl])
        np.testing.assert_array_equal(grad, W[:, s * Sl : (s + 1) * Sl])


def test_ulysses_needs_divisible_heads():
    """P must divide Hq and Hkv (JAX's and the reference's constraint)."""
    axis = pmesh.Axis("seq", 3, 0, None, None)
    q = torch.zeros(1, 4, 6, 2)
    with pytest.raises(ValueError, match="divisible by 3"):
        ulysses.ulysses_attention(lambda q, k, v: q, q, torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 4, 2), axis)


# ---------------------------------------------------------------------------
# The two-way forward and the loss on the (data, seq) mesh
# ---------------------------------------------------------------------------


def _jax_two_way_sharded(jp, jcfg, gates, ids):
    """JAX's forward_two_way under shard_map at (data 2, seq 2)."""
    mesh = JMesh(np.array(jax.devices()[:N]).reshape(DP, SP), axis_names=("data", "seq"))

    def f(ids_shard):
        return jllama.forward_two_way(jp, jnp.asarray(gates), jcfg, SINK, RECENT, ids_shard, seq_axis="seq",
                                      block_k=BLOCK)

    return shard_map(f, mesh=mesh, in_specs=P("data", "seq"), out_specs=P("data", "seq"), check_vma=False)(ids)


def test_two_way_sharded_matches_one_process_and_jax(tiny, mesh_ds):
    """forward_two_way at sp = 2 (Ulysses) and dp = 2: the assembled teacher
    and student equal the one-process forward and JAX's shard_map forward
    (atol 3e-4, as tests/test_train.py's Ulysses test)."""
    tcfg, jcfg, tp, jp = tiny
    ids = BATCHES[0][0]
    g = _gates(tcfg)
    with torch.no_grad():
        t1, s1 = tllama.forward_two_way(tp, torch.as_tensor(g), tcfg, SINK, RECENT, torch.as_tensor(ids).long(),
                                        block_k=BLOCK)
    jt, js = _jax_two_way_sharded(jp, jcfg, g, jnp.asarray(ids))
    for field, one, jx in (("teacher", t1, jt), ("student", s1, js)):
        got = _assemble(mesh_ds["ranks"], "two_way", field)
        np.testing.assert_allclose(got, one.numpy(), atol=HIDDEN_ATOL)
        np.testing.assert_allclose(got, np.asarray(jx), atol=HIDDEN_ATOL)
    # FSDP with remat: the same forward, the layers gathered where used
    for field in ("teacher", "student"):
        np.testing.assert_allclose(_assemble(mesh_ds["ranks"], "two_way_fsdp_remat", field),
                                   _assemble(mesh_ds["ranks"], "two_way", field), atol=1e-6)


def test_distill_loss_over_the_axes_matches_jax(tiny, mesh_ds):
    """distill_loss(axis_names=(data, seq)) is the global loss on every rank:
    JAX's distill_loss of the whole teacher and student, rtol 1e-5."""
    ranks = mesh_ds["ranks"]
    teacher, student = _assemble(ranks, "two_way", "teacher"), _assemble(ranks, "two_way", "student")
    mask = _shift(BATCHES[0][1]) != IGNORE_INDEX
    want = float(jloss.distill_loss(jnp.asarray(teacher), jnp.asarray(student), jnp.asarray(mask)))
    assert want > 0
    for r in ranks:
        np.testing.assert_allclose(r["two_way"]["distill"], want, rtol=1e-5)
        assert r["two_way_fsdp_remat"]["distill"] == pytest.approx(r["two_way"]["distill"], rel=1e-5)


# ---------------------------------------------------------------------------
# The sharded step against JAX's
# ---------------------------------------------------------------------------

_capture = optax.GradientTransformation(lambda p: jnp.zeros_like(p), lambda g, s, p=None: (jnp.zeros_like(g), g))


def _jax_sharded_grads(jp, jcfg, tmp_path, batch, reg_weight=0.0):
    """JAX's dp x sp step with an optimizer that keeps the gradient as its
    state and moves nothing: (grad, loss, distill, reg)."""
    jt = _tcfg(jtrainer, tmp_path, reg_weight=reg_weight)
    mesh = jtrainer.build_mesh_for(jt)
    step = jtrainer.make_train_step(jcfg, jt, _capture, mesh)
    gates = jnp.asarray(_gates(jcfg))
    sh = NamedSharding(mesh, P("data", "seq"))
    ids, labels = (jax.device_put(jnp.asarray(a), sh) for a in (batch[0], _shift(batch[1])))
    _, grad, loss, (d, reg) = step(gates, _capture.init(gates), jp, ids, labels)
    return np.asarray(grad), float(loss), float(d), float(reg)


def test_sharded_gradient_is_n_times_one_process(tiny, mesh_ds, tmp_path):
    """The N pin: at reg_weight 0 and gates 0.6, the port's sharded gradient
    is N = 4 times its one-process gradient of the same global batch (1e-5
    relative) and equals JAX's sharded gradient, which is N times JAX's
    one-device one (loss.py:41-42, trainer.py:140)."""
    tcfg, jcfg, tp, jp = tiny
    one = ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path / "one", dp=1, sp=1, reg_weight=0.0), device="cpu")
    with torch.no_grad():
        one.gates.copy_(torch.as_tensor(_gates(tcfg)))
    one.compute_grads(*BATCHES[0])
    one_grad = one.gates.grad.numpy()
    scale = np.abs(one_grad).max() * N
    assert scale > 0
    jgrad, jloss_, jd, _ = _jax_sharded_grads(jp, jcfg, tmp_path / "jax", BATCHES[0])
    for r in mesh_ds["ranks"]:
        got = r["grads"]["grads"][0]
        np.testing.assert_allclose(got, N * one_grad, atol=GRAD_REL * scale)
        np.testing.assert_allclose(got, jgrad, atol=GRAD_REL * scale)
        np.testing.assert_allclose(r["grads"]["losses"][0][1], jd, atol=LOSS_ATOL)
    # and JAX's own one-device gradient is the port's one-process one
    jone = jtrainer.make_train_step(jcfg, _tcfg(jtrainer, tmp_path / "j1", dp=1, sp=1, reg_weight=0.0), _capture)
    g0 = jnp.asarray(_gates(jcfg))
    _, jone_grad, _, _ = jone(g0, _capture.init(g0), jp, jnp.asarray(BATCHES[0][0]), jnp.asarray(_shift(BATCHES[0][1])))
    np.testing.assert_allclose(np.asarray(jgrad), N * np.asarray(jone_grad), atol=GRAD_REL * scale)
    np.testing.assert_allclose(one_grad, np.asarray(jone_grad), atol=GRAD_REL * scale / N)


def test_sharded_steps_match_jax(tiny, mesh_ds, tmp_path):
    """Two dp 2 x sp 2 GateTrainer steps from gates 0.6: loss, distill and
    reg (atol 1e-5) and the gates after each step (atol 2e-5) equal JAX's
    sharded trainer's; every rank holds the same gates."""
    tcfg, jcfg, tp, jp = tiny
    jt_cfg = _tcfg(jtrainer, tmp_path / "jax")
    jt = jtrainer.GateTrainer(jp, jcfg, jt_cfg, jtrainer.build_mesh_for(jt_cfg))
    jt.gates = jnp.asarray(_gates(jcfg))
    jt.opt_state = jt.optimizer.init(jt.gates)
    ranks = mesh_ds["ranks"]
    for i, (ids, labels) in enumerate(BATCHES):
        jl = jt.train_step(ids, labels)
        for r in ranks:
            np.testing.assert_allclose(r["steps"]["losses"][i], jl, atol=LOSS_ATOL)
            np.testing.assert_allclose(r["steps"]["gates"][i], np.asarray(jt.gates), atol=GATES_ATOL)
            np.testing.assert_array_equal(r["steps"]["gates"][i], ranks[0]["steps"]["gates"][i])
    assert not np.allclose(ranks[0]["steps"]["gates"][-1], _gates(tcfg))  # the gates moved


def test_training_collectives_of_a_step(tiny, mesh_ds):
    """A step's collectives against their reckoning: each layer's attention
    is 4 all_to_alls in the teacher, 4 in the student's forward, 4 in its
    recompute (remat) and 4 in its backward, but the first layer's backward,
    whose attention inputs do not depend on the gates; the loss takes one all_reduce
    an axis and the gradient one more; FSDP adds one all_gather of a layer's
    slices for the teacher, the student and its recompute (without remat,
    one: teacher and student share the gathered layer)."""
    tcfg = tiny[0]
    L = tcfg.num_layers
    want = {"all_to_all": 16 * L - 4, "all_gather": 0, "all_reduce.sum": 3}
    r = mesh_ds["ranks"][0]
    assert r["steps"]["collectives"][0] == want
    assert r["fsdp"]["collectives"][0] == {**want, "all_gather": 3 * L}
    assert r["fsdp_no_remat"]["collectives"][0] == {**want, "all_to_all": 12 * L - 4, "all_gather": L}
    for key, fs, remat in (("steps", False, True), ("fsdp", True, True), ("fsdp_no_remat", True, False)):
        reckoned = ttrainer.collectives_per_step(tcfg, _tcfg(ttrainer, "unused", fsdp=fs, remat=remat))
        assert all(x["collectives"][0] == x["collectives"][1] == reckoned for x in (r[key],))


# ---------------------------------------------------------------------------
# FSDP (tests/test_fsdp.py)
# ---------------------------------------------------------------------------


def test_fsdp_step_matches_replicated(tiny, mesh_ds):
    """FSDP changes memory, not math: its losses (atol 1e-5) and gates (atol
    2e-5) equal the replicated step's, and a rank's layer leaves are slices
    (a quarter of the whole leaf on its split dim)."""
    tcfg, _, tp, _ = tiny
    specs = fsdp.param_specs(tp, N)["layers"][0]
    for r in mesh_ds["ranks"]:
        for i in range(len(BATCHES)):
            np.testing.assert_allclose(r["fsdp"]["losses"][i], r["steps"]["losses"][i], atol=LOSS_ATOL)
            np.testing.assert_allclose(r["fsdp"]["gates"][i], r["steps"]["gates"][i], atol=GATES_ATOL)
        for key, shape in r["fsdp"]["layer0_shapes"].items():
            whole = tuple(tp["layers"][0][key].shape)
            d = specs[key]
            assert d is not None and shape == whole[:d] + (whole[d] // N,) + whole[d + 1 :], (key, shape, whole)
        assert r["steps"]["layer0_shapes"] == {k: tuple(v.shape) for k, v in tp["layers"][0].items()}


def test_fsdp_remat_step_matches_no_remat(mesh_ds):
    """Per-layer checkpointing under FSDP (the student's block gathers its
    layer again in the backward) gives the steps of FSDP without remat."""
    for r in mesh_ds["ranks"]:
        for i in range(len(BATCHES)):
            np.testing.assert_allclose(r["fsdp"]["losses"][i], r["fsdp_no_remat"]["losses"][i], atol=LOSS_ATOL)
            np.testing.assert_allclose(r["fsdp"]["gates"][i], r["fsdp_no_remat"]["gates"][i], atol=GATES_ATOL)


def test_param_specs_shard_layers_only(tiny):
    """Only the layers split (tests/test_fsdp.py): the embedding, the head and
    the final norm stay whole; every weight of tiny-gqa has a dim that 8
    divides, the 1-D norms too; the split dim is the largest that divides."""
    tp = tiny[2]
    specs = fsdp.param_specs(tp, 8)
    assert all(specs[k] is None for k in tp if k != "layers")
    layer0 = specs["layers"][0]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "input_norm", "post_norm"):
        shape = tp["layers"][0][name].shape
        assert layer0[name] == max((d for d in range(len(shape)) if shape[d] % 8 == 0), key=lambda d: shape[d])
    assert fsdp._shard_dim((6, 10), 4) is None and fsdp._shard_dim((8, 12), 4) == 1


def test_resume_across_ranks(tiny, mesh_ds, tmp_path):
    """Rank 0 wrote the checkpoint after two sharded steps; a new trainer on
    every rank resumes it (step 2, the gates and Adam's mu of the run), and
    the JAX trainer reads it back too."""
    tcfg, jcfg, _, jp = tiny
    for r in mesh_ds["ranks"]:
        ok, step, gates, mu = r["steps"]["resumed"]
        assert ok and step == 2
        np.testing.assert_array_equal(gates, r["steps"]["gates"][-1])
        np.testing.assert_array_equal(mu, mesh_ds["ranks"][0]["steps"]["resumed"][3])
    back = jtrainer.GateTrainer(jp, jcfg, _tcfg(jtrainer, mesh_ds["out"] / "repl", dp=1, sp=1))
    assert back.resume() and back.step_idx == 2
    np.testing.assert_array_equal(np.asarray(back.gates), mesh_ds["ranks"][0]["steps"]["gates"][-1])


def test_dryrun_train_step(tmp_path):
    """ttrainer.dryrun_train_step(4) (JAX's dryrun_train_step: dp 2 x sp 2,
    tiny shapes): a finite loss, the same on every rank."""
    out = ttrainer.dryrun_train_step(4, device="cpu", timeout_s=SPAWN_TIMEOUT_S, store_dir=str(tmp_path))
    assert np.isfinite(out["loss"]) and out["gates"].shape == (2, 4)


def test_trainer_needs_the_mesh_it_is_configured_for(tiny, tmp_path):
    """dp x sp > 1 without a mesh, or with a mesh of another shape, raises."""
    tcfg, _, tp, _ = tiny
    with pytest.raises(ValueError, match="needs this rank's"):
        ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path), device="cpu")
    fake = pmesh.Mesh(tensor=2, data=1, rank=0, tensor_rank=0, data_rank=0, tensor_group=None, data_group=None,
                      tensor_src=0, backend="gloo", device=torch.device("cpu"), inner="seq")
    with pytest.raises(ValueError, match="needs this rank's"):
        ttrainer.GateTrainer(tp, tcfg, _tcfg(ttrainer, tmp_path), device="cpu", mesh=fake)


def test_one_spawn_stays_cheap(mesh_ds):
    """The module's one spawn (4 ranks, 7 jobs) keeps tier-1 cheap."""
    assert mesh_ds["seconds"] < 120, mesh_ds["seconds"]
