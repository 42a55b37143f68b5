"""Tokenizer loading with an offline-safe fallback.

The port's own copy of duo_attention_tpu/tokenizer.py. The reference always
loads HF tokenizers (duo_attn/utils.py:288-299); with no checkpoint at hand
the eval harnesses fall back to a deterministic byte-level tokenizer (the
harness logic is tokenizer-agnostic). ``WordTokenizer`` gives the ids the
constructed circuit (``models/constructed.py``) is written for: the known
words of the synthetic tasks first, in the JAX package's order, every other
word by its md5 hash, so both packages give every text the same ids.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """Deterministic byte-level tokenizer: id = byte + 3 (0=pad, 1=bos, 2=eos)."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return [self.bos_token_id] + ids if add_bos else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        # ids outside the byte range (e.g. from random-weight test models
        # with a larger vocab) are dropped rather than crashing
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) < 259)
        return data.decode("utf-8", errors="ignore")

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}


class WordTokenizer:
    """Whitespace/punctuation word tokenizer with stable hashed ids.

    For offline synthetic tasks (passkey pretraining + the accuracy loop,
    evals/accuracy_loop.py): one token per word turns passkey retrieval
    into the canonical induction-head copy task — the same granularity a
    real BPE gives the reference's NATO-alphabet passkeys
    (duo_attn/data.py). Ids are stable hashes of the token text, so no
    fitted vocabulary is needed; decoding uses the inverse map collected
    while encoding (sufficient in-process, where scoring happens).
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self._inv = {}
        # Explicit ids for the closed word set of the synthetic tasks —
        # hashing ~110 task words into 512 slots would produce ~12 id
        # collisions (names aliasing haystack/code words corrupts the
        # retrieval task and its scoring). Unknown words hash into the
        # slots above the known block.
        self._vocab = {}
        for w in self._known_words():
            if w not in self._vocab:
                self._vocab[w] = 3 + len(self._vocab)
                self._inv[self._vocab[w]] = w
        assert len(self._vocab) + 3 < vocab_size, "vocab_size too small"
        self._hash_base = 3 + len(self._vocab)

    @staticmethod
    def _known_words():
        from .evals.niah import _WORDS
        from .train.data import _CODE_WORDS, _NAMES

        template = (
            "Remember this the secret code of is Question what Answer "
            ". : ? ,"
        ).split()
        caps = [w.capitalize() for w in _WORDS]
        return [*_WORDS, *caps, *_NAMES, *_CODE_WORDS, *template]

    def _id(self, tok: str) -> int:
        i = self._vocab.get(tok)
        if i is None:
            import hashlib

            h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:8], "little")
            i = self._hash_base + h % (self.vocab_size - self._hash_base)
            self._inv.setdefault(i, tok)
        return i

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        import re

        toks = re.findall(r"\w+|[^\w\s]", text)
        ids = [self._id(t) for t in toks]
        return [self.bos_token_id] + ids if add_bos else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = [self._inv.get(int(i)) for i in ids]
        return " ".join(w for w in words if w is not None)

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}


def get_tokenizer(name_or_path: Optional[str] = None):
    """HF tokenizer when available, ByteTokenizer otherwise."""
    if name_or_path in (None, "byte"):
        return ByteTokenizer()
    if name_or_path == "word":
        return WordTokenizer()
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path, trust_remote_code=True)
    except Exception:
        return ByteTokenizer()


def encode_ids(tokenizer, text: str) -> List[int]:
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.encode(text)
    return tokenizer(text, truncation=False, return_tensors=None)["input_ids"]


def decode_ids(tokenizer, ids) -> str:
    return tokenizer.decode(list(map(int, ids)), skip_special_tokens=True)
