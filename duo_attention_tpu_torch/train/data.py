"""Synthetic multi-passkey retrieval dataset for gate training.

The port's own copy of duo_attention_tpu/train/data.py (numpy only): the
samples, word lists and ids equal the JAX package's
(tests/test_torch_tokenizer_metrics.py). The evals use it now: its word
lists make the word tokenizer's vocabulary and the constructed circuit's
signatures, and ``evals/accuracy_loop.py::eval_retrieval`` draws its prompts
from ``MultiPasskeyDataset``.

Capability counterpart of MultiplePasskeyRetrievalDataset
(duo_attn/data.py:18-313): a long filler haystack with N passkey sentences
inserted at sampled depths, followed by recall questions; labels are -100
on context and supervised only on the answer spans; context lengths are
linspaced over [min, max] across the dataset; sequences pad to a multiple
(divisibility for sequence-parallel shards). The reference draws its
haystack from booksum and passkeys from the NATO alphabet; this build is
offline-first: procedural filler text (or a user corpus file) and its own
word lists. Tokenizer-agnostic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..evals.niah import procedural_haystack

_NAMES = (
    "aurora bramble cedar dahlia ember fable garnet hazel iris juniper "
    "kestrel larkspur maple nutmeg onyx poppy quartz rowan saffron thistle"
).split()
_CODE_WORDS = (
    "anchor breeze canyon dusk echo flint grove harbor inlet jade knoll "
    "lagoon mesa nectar orchid prairie quarry ridge summit tundra umber "
    "violet willow xenon yonder zephyr"
).split()

IGNORE_INDEX = -100


@dataclass
class PasskeyDataConfig:
    context_length_min: int = 1024
    context_length_max: int = 4096
    context_lengths_num_intervals: int = 8
    num_passkeys: int = 4
    passkey_length: int = 4  # code words per passkey
    pad_to_multiple: int = 64
    haystack_path: Optional[str] = None  # text file; procedural if None
    seed: int = 42


class MultiPasskeyDataset:
    """Deterministic per-index sample construction (no stored corpus)."""

    def __init__(self, tokenizer, config: PasskeyDataConfig, num_samples: int = 2000):
        self.tokenizer = tokenizer
        self.cfg = config
        self.num_samples = num_samples
        self.context_lengths = np.linspace(
            config.context_length_min,
            config.context_length_max,
            config.context_lengths_num_intervals,
            dtype=int,
        )
        self._haystack_text = None
        if config.haystack_path:
            with open(config.haystack_path, encoding="utf-8", errors="ignore") as f:
                self._haystack_text = f.read()

    def __len__(self) -> int:
        return self.num_samples

    def _encode(self, text: str) -> List[int]:
        from ..tokenizer import encode_ids

        ids = encode_ids(self.tokenizer, text)
        # strip a leading BOS so concatenation is clean
        bos = getattr(self.tokenizer, "bos_token_id", None)
        if bos is not None and ids and ids[0] == bos:
            ids = ids[1:]
        return ids

    def build_text(self, idx: int) -> Tuple[str, List[str], List[str]]:
        rng = np.random.default_rng(self.cfg.seed + idx)
        n = self.cfg.num_passkeys
        names = list(rng.choice(_NAMES, size=n, replace=False))
        # all code words of a sample are distinct: a repeated word makes
        # the continuation ambiguous (two different successors for the
        # same word), which caps achievable retrieval accuracy for ANY
        # model — same reason the reference draws passkey word sequences
        # from a large alphabet (duo_attn/data.py:19)
        k = self.cfg.passkey_length
        flat = rng.choice(
            _CODE_WORDS, size=min(n * k, len(_CODE_WORDS)), replace=False
        )
        codes = [
            " ".join(flat[i * k : (i + 1) * k]) for i in range(n)
        ]
        return names, codes, rng

    def _assemble_context(self, idx: int):
        """Haystack with passkeys inserted at sampled depths; returns
        (context_ids, names, codes)."""
        cfg = self.cfg
        ctx_len = int(self.context_lengths[idx % len(self.context_lengths)])
        names, codes, rng = self.build_text(idx)

        # token budget bookkeeping
        passkey_sents = [
            f" Remember this: the secret code of {name} is {code}. "
            for name, code in zip(names, codes)
        ]
        questions = [
            f"\nQuestion: the secret code of {name} is {code}."
            for name, code in zip(names, codes)
        ]
        q_ids = [self._encode(q) for q in questions]
        p_ids = [self._encode(p) for p in passkey_sents]

        budget = ctx_len - sum(len(x) for x in q_ids) - sum(len(x) for x in p_ids)
        budget = max(budget, 64)
        if self._haystack_text:
            start = int(rng.integers(0, max(len(self._haystack_text) - budget * 6, 1)))
            hay = self._haystack_text[start : start + budget * 6]
        else:
            hay = procedural_haystack(budget * 6, seed=cfg.seed + idx)
        hay_ids = self._encode(hay)[:budget]

        # insert passkeys at sorted random depths; BOS leads the sequence
        # (attention-sink anchor — models rely on it, reference sink_size
        # serves the same role at deployment)
        depths = sorted(rng.integers(0, max(len(hay_ids), 1), size=len(p_ids)))
        bos = getattr(self.tokenizer, "bos_token_id", None)
        ids: List[int] = [] if bos is None else [bos]
        prev = 0
        for d, p in zip(depths, p_ids):
            ids.extend(hay_ids[prev:d])
            ids.extend(p)
            prev = d
        ids.extend(hay_ids[prev:])
        return ids, names, codes

    def __getitem__(self, idx: int):
        """Returns dict(input_ids [S], labels [S]) as numpy int32/int64."""
        cfg = self.cfg
        ids, names, codes = self._assemble_context(idx)
        # The recall prompt restates the passkey sentence's n-gram ("the
        # secret code of {name} is") so the answer is a literal
        # continuation — the same restating trick as the reference's
        # "what is the ... passkey?\nPasskey: " prompt (duo_attn/
        # data.py:78-79), and the form a from-scratch tiny model can
        # learn via prefix-match induction.
        questions = [
            f"\nQuestion: the secret code of {name} is {code}."
            for name, code in zip(names, codes)
        ]
        q_ids = [self._encode(q) for q in questions]
        # answer span = tokens of " {code}." suffix — supervise those
        ans_ids = [self._encode(f" {code}.") for code in codes]

        labels = [IGNORE_INDEX] * len(ids)
        for q, a in zip(q_ids, ans_ids):
            ids = ids + q
            labels.extend([IGNORE_INDEX] * (len(q) - len(a)) + q[-len(a):])

        # pad (right) to multiple — padding is never supervised
        m = cfg.pad_to_multiple
        pad = (-len(ids)) % m
        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        ids = ids + [pad_id] * pad
        labels = labels + [IGNORE_INDEX] * pad
        return {
            "input_ids": np.asarray(ids, np.int32),
            "labels": np.asarray(labels, np.int64),
        }

    def eval_prompt(self, idx: int, question_index: int = 0):
        """Generation-style eval sample: context + ONE question cut at
        "Answer:", plus the expected answer text. Returns
        (input_ids [S] int32, answer_text str)."""
        ids, names, codes = self._assemble_context(idx)
        qi = question_index % len(names)
        q = f"\nQuestion: the secret code of {names[qi]} is"
        ids = ids + self._encode(q)
        return np.asarray(ids, np.int32), codes[qi]


def collate(samples: List[dict], pad_to: Optional[int] = None) -> dict:
    """Left-pad-free batch collation to the max (or given) length."""
    maxlen = pad_to or max(len(s["input_ids"]) for s in samples)
    B = len(samples)
    ids = np.zeros((B, maxlen), np.int32)
    labels = np.full((B, maxlen), IGNORE_INDEX, np.int64)
    for i, s in enumerate(samples):
        n = min(len(s["input_ids"]), maxlen)
        ids[i, :n] = s["input_ids"][:n]
        labels[i, :n] = s["labels"][:n]
    return {"input_ids": ids, "labels": labels}


def data_iterator(dataset, batch_size: int, pad_to: Optional[int] = None):
    """Sequential batches; each batch padded to a common length."""
    i = 0
    while True:
        samples = [dataset[(i + j) % len(dataset)] for j in range(batch_size)]
        i += batch_size
        yield collate(samples, pad_to)
