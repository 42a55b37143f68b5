"""Synthetic multi-passkey sequences for gate training, frozen.

Copied from ``duo_attention_tpu_torch/train/data.py`` at commit abc807a
(``MultiPasskeyDataset``, its word lists, ``IGNORE_INDEX``), with the byte
tokenizer of ``tokenizer.py`` and ``procedural_haystack`` and ``_WORDS`` of
``evals/niah.py`` that it calls, so that a later change to the program
cannot change the training cell's inputs. Left out: the corpus-file
haystack, ``eval_prompt``, ``collate`` and the iterator, which the benchmark
does not use. Numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

_NAMES = (
    "aurora bramble cedar dahlia ember fable garnet hazel iris juniper "
    "kestrel larkspur maple nutmeg onyx poppy quartz rowan saffron thistle"
).split()
_CODE_WORDS = (
    "anchor breeze canyon dusk echo flint grove harbor inlet jade knoll "
    "lagoon mesa nectar orchid prairie quarry ridge summit tundra umber "
    "violet willow xenon yonder zephyr"
).split()
_WORDS = (
    "river meadow lantern harvest compass timber orchard saddle copper "
    "bellows brook thicket granite whisper barley crag hollow ember "
    "drift pasture mill crossing ledger wharf spindle furrow"
).split()

IGNORE_INDEX = -100
BOS_ID, PAD_ID = 1, 0


def encode(text: str) -> List[int]:
    """The byte tokenizer: id = byte + 3 (0 pad, 1 bos, 2 eos), no BOS."""
    return [b + 3 for b in text.encode("utf-8")]


def procedural_haystack(num_chars: int, seed: int = 0) -> str:
    """Deterministic filler prose (stands in for a text corpus)."""
    rng = np.random.default_rng(seed)
    out = []
    n = 0
    while n < num_chars:
        k = rng.integers(8, 16)
        words = rng.choice(_WORDS, size=k)
        sent = " ".join(words).capitalize() + ". "
        out.append(sent)
        n += len(sent)
    return "".join(out)[:num_chars]


@dataclass
class PasskeyDataConfig:
    context_length_min: int = 1024
    context_length_max: int = 4096
    context_lengths_num_intervals: int = 8
    num_passkeys: int = 4
    passkey_length: int = 4  # code words per passkey
    pad_to_multiple: int = 64
    seed: int = 42


class MultiPasskeyDataset:
    """Deterministic per-index sample construction (no stored corpus)."""

    def __init__(self, config: PasskeyDataConfig):
        self.cfg = config
        self.context_lengths = np.linspace(config.context_length_min, config.context_length_max,
                                           config.context_lengths_num_intervals, dtype=int)

    def build_text(self, idx: int):
        rng = np.random.default_rng(self.cfg.seed + idx)
        n = self.cfg.num_passkeys
        names = list(rng.choice(_NAMES, size=n, replace=False))
        k = self.cfg.passkey_length
        flat = rng.choice(_CODE_WORDS, size=min(n * k, len(_CODE_WORDS)), replace=False)
        codes = [" ".join(flat[i * k : (i + 1) * k]) for i in range(n)]
        return names, codes, rng

    def _assemble_context(self, idx: int):
        """Haystack with passkeys inserted at sampled depths; returns
        (context_ids, names, codes)."""
        cfg = self.cfg
        ctx_len = int(self.context_lengths[idx % len(self.context_lengths)])
        names, codes, rng = self.build_text(idx)
        passkey_sents = [f" Remember this: the secret code of {name} is {code}. "
                         for name, code in zip(names, codes)]
        questions = [f"\nQuestion: the secret code of {name} is {code}." for name, code in zip(names, codes)]
        q_ids = [encode(q) for q in questions]
        p_ids = [encode(p) for p in passkey_sents]
        budget = ctx_len - sum(len(x) for x in q_ids) - sum(len(x) for x in p_ids)
        budget = max(budget, 64)
        hay = procedural_haystack(budget * 6, seed=cfg.seed + idx)
        hay_ids = encode(hay)[:budget]
        depths = sorted(rng.integers(0, max(len(hay_ids), 1), size=len(p_ids)))
        ids: List[int] = [BOS_ID]
        prev = 0
        for d, p in zip(depths, p_ids):
            ids.extend(hay_ids[prev:d])
            ids.extend(p)
            prev = d
        ids.extend(hay_ids[prev:])
        return ids, names, codes

    def __getitem__(self, idx: int):
        """dict(input_ids [S] int32, labels [S] int64): labels supervise the
        answer spans only; padded right to a multiple of pad_to_multiple."""
        cfg = self.cfg
        ids, names, codes = self._assemble_context(idx)
        questions = [f"\nQuestion: the secret code of {name} is {code}." for name, code in zip(names, codes)]
        q_ids = [encode(q) for q in questions]
        ans_ids = [encode(f" {code}.") for code in codes]
        labels = [IGNORE_INDEX] * len(ids)
        for q, a in zip(q_ids, ans_ids):
            ids = ids + q
            labels.extend([IGNORE_INDEX] * (len(q) - len(a)) + q[-len(a):])
        pad = (-len(ids)) % cfg.pad_to_multiple
        ids = ids + [PAD_ID] * pad
        labels = labels + [IGNORE_INDEX] * pad
        return {"input_ids": np.asarray(ids, np.int32), "labels": np.asarray(labels, np.int64)}
