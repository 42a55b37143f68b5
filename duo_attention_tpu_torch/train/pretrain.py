"""Tiny-LM pretraining on the multi-passkey task.

Counterpart of duo_attention_tpu/train/pretrain.py: a small Llama (this
package's own model) trained from scratch with full attention on the passkey
data (``train/data.py``), with a copy curriculum every fourth batch, so that
a retrieval-capable model exists without a downloaded checkpoint. It is the
``lm="pretrain"`` option of ``evals/accuracy_loop.py``.

Next-token cross-entropy over the real positions, the answer tokens weighted
``answer_weight``. optax's ``chain(clip_by_global_norm, adamw(linear
schedule))`` becomes ``torch.nn.utils.clip_grad_norm_`` followed by
``torch.optim.AdamW``, whose lr goes linearly from 0 to ``lr`` over the
warmup and then stays constant, evaluated at the count of earlier updates
as optax does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models import llama
from ..utils import resolve_device
from .data import IGNORE_INDEX, MultiPasskeyDataset, PasskeyDataConfig, data_iterator

# Gate-trainable tiny model: 4 layers x 4 KV heads (GQA 2x).
TINY_LM = ModelConfig(
    vocab_size=512,  # covers ByteTokenizer (<259) and WordTokenizer (512)
    hidden_size=256,
    intermediate_size=512,
    num_layers=4,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    rope_theta=10000.0,
    max_position_embeddings=8192,
)


@dataclass
class PretrainConfig:
    num_steps: int = 3000
    batch_size: int = 8
    lr: float = 3e-3
    warmup_steps: int = 100
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 100
    # loss weight of the supervised answer tokens against the rest of the
    # sequence (plain LM loss plateaus with the filler's entropy dominating)
    answer_weight: float = 10.0


def lm_loss(params, cfg: ModelConfig, ids: torch.Tensor, labels: Optional[torch.Tensor] = None, pad_id: int = 0,
            answer_weight: float = 1.0) -> torch.Tensor:
    """Next-token CE over all real positions (padding excluded); positions
    whose labels mark an answer span get ``answer_weight``."""
    logits = llama.head_logits(params, llama.forward_full_attention(params, cfg, ids))[:, :-1]
    targets = ids[:, 1:]
    w = (targets != pad_id).float()
    if labels is not None and answer_weight != 1.0:
        w = w * (1.0 + (answer_weight - 1.0) * (labels[:, 1:] != IGNORE_INDEX).float())
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="none")
    return (ce.reshape(w.shape) * w).sum() / torch.clamp(w.sum(), min=1.0)


def _leaves(params):
    for key, val in params.items():
        if key == "layers":
            for layer in val:
                yield from layer.values()
        else:
            yield val


def make_step(params, cfg: ModelConfig, pcfg: PretrainConfig):
    """step(ids, labels) -> loss float: one update of ``params`` in place
    (their tensors are made trainable, under an AdamW of their own)."""
    warmup = min(pcfg.warmup_steps, max(pcfg.num_steps // 10, 1))
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=pcfg.weight_decay,
                            foreach=False)
    count = [0]

    def step(ids, labels):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(params, cfg, ids, labels, answer_weight=pcfg.answer_weight)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(leaves, pcfg.grad_clip)
        # constant after warmup: the induction circuit emerges in a late
        # phase transition, which a decaying schedule can starve
        opt.param_groups[0]["lr"] = pcfg.lr * min(count[0], warmup) / warmup
        opt.step()
        count[0] += 1
        return float(loss.detach())

    return step


def copy_batch(rng: np.random.Generator, batch_size: int, seq_len: int, vocab_size: int) -> dict:
    """Copy-curriculum batch: per row a random segment of random length
    tiled to fill the sequence, supervised after its first period. The
    period varies by row, so the model must learn content-based prefix
    matching, not a positional offset."""
    ids = np.empty((batch_size, seq_len), np.int32)
    labels = np.full((batch_size, seq_len), IGNORE_INDEX, np.int64)
    for b in range(batch_size):
        seg_len = int(rng.integers(48, seq_len // 2))
        seg = rng.integers(3, vocab_size, seg_len)
        row = np.tile(seg, seq_len // seg_len + 1)[:seq_len]
        ids[b] = row
        labels[b, seg_len:] = row[seg_len:]
    return {"input_ids": ids, "labels": labels}


def pretrain(cfg: ModelConfig = TINY_LM, pcfg: PretrainConfig = PretrainConfig(),
             dcfg: Optional[PasskeyDataConfig] = None, tokenizer=None, params=None, device="cuda"):
    """Train (or continue training) the tiny LM on ``device``; returns
    (params, losses). Without ``params`` it starts from ``init_params``
    (float32, a generator seeded with ``pcfg.seed``)."""
    from ..tokenizer import get_tokenizer

    device = resolve_device(device)
    tokenizer = tokenizer or get_tokenizer("byte")
    dcfg = dcfg or PasskeyDataConfig(context_length_min=256, context_length_max=1024, num_passkeys=2,
                                     passkey_length=3)
    seq_len = dcfg.context_length_max + 256
    it = data_iterator(MultiPasskeyDataset(tokenizer, dcfg, num_samples=100_000), pcfg.batch_size, pad_to=seq_len)
    if params is None:
        params = llama.init_params(cfg, seed=pcfg.seed, dtype=torch.float32, device=device)
    step = make_step(params, cfg, pcfg)
    losses = []
    copy_rng = np.random.default_rng(pcfg.seed + 1)
    for i in range(pcfg.num_steps):
        batch = copy_batch(copy_rng, pcfg.batch_size, seq_len, cfg.vocab_size) if i % 4 == 3 else next(it)
        loss = step(*(torch.as_tensor(batch[k], dtype=torch.long, device=device) for k in ("input_ids", "labels")))
        if i % pcfg.log_every == 0 or i == pcfg.num_steps - 1:
            losses.append((i, loss))
            print(f"[pretrain] step {i} loss {loss:.4f}", flush=True)
    for t in _leaves(params):
        t.requires_grad_(False)
    return params, losses


@torch.no_grad()
def answer_token_accuracy(params, cfg: ModelConfig, dataset, n_samples: int = 16, offset: int = 0) -> float:
    """Teacher-forced argmax accuracy on the supervised (answer) tokens only:
    the passkey codes the model must copy from deep in the context."""
    device = params["final_norm"].device
    correct = total = 0
    for i in range(n_samples):
        s = dataset[offset + i]
        ids = torch.as_tensor(s["input_ids"], dtype=torch.long, device=device)[None]
        logits = llama.head_logits(params, llama.forward_full_attention(params, cfg, ids))[0]
        pred_next = logits[:-1].argmax(-1).cpu().numpy()  # the prediction for position t+1
        labels = s["labels"]
        sup = labels[1:] != IGNORE_INDEX
        correct += int((pred_next[sup] == labels[1:][sup]).sum())
        total += int(sup.sum())
    return correct / max(total, 1)


def save_lm(params, path: str):
    from ..models.convert import save_params_npz

    save_params_npz(params, path)


def load_lm(path: str, cfg: ModelConfig = TINY_LM, device="cuda"):
    from ..models.convert import load_params_npz

    return load_params_npz(path, cfg, torch.float32, device=device)
