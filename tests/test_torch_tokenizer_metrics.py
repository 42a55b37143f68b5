"""The port's tokenizers, scorers and passkey data against the JAX package's.

The port keeps its own copies of duo_attention_tpu/tokenizer.py,
evals/metrics.py, train/data.py and the word lists of evals/niah.py (it
imports nothing of the JAX package). The constructed circuit's weights are
written for the word tokenizer's ids, so the copies must agree exactly:
word lists, ids and decodes on the needle, the haystack and the LongBench
records, every scorer's value on English and Chinese text, and every passkey
sample. Equality is exact throughout (ids, strings and scores; a score is a
Python float computed by the same arithmetic).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from duo_attention_tpu import tokenizer as jtok
from duo_attention_tpu.evals import metrics as jM
from duo_attention_tpu.evals import niah as jniah
from duo_attention_tpu.train import data as jdata
from duo_attention_tpu_torch import tokenizer as ttok
from duo_attention_tpu_torch.evals import metrics as tM
from duo_attention_tpu_torch.evals import niah as tniah
from duo_attention_tpu_torch.train import data as tdata

REPO = Path(__file__).resolve().parent.parent
LONGBENCH = REPO / "artifacts" / "longbench_tpu" / "data"


def test_word_lists_and_needle_equal():
    assert tniah._WORDS == jniah._WORDS
    assert tdata._NAMES == jdata._NAMES and tdata._CODE_WORDS == jdata._CODE_WORDS
    assert tdata.IGNORE_INDEX == jdata.IGNORE_INDEX
    for name in ("DEFAULT_NEEDLE", "DEFAULT_QUESTION", "DEFAULT_ANSWER"):
        assert getattr(tniah, name) == getattr(jniah, name), name


@pytest.mark.parametrize("seed", [0, 7, 1300])
def test_procedural_haystack_equal(seed):
    assert tniah.procedural_haystack(5000, seed=seed) == jniah.procedural_haystack(5000, seed=seed)
    assert tniah.load_haystack(None, 3000) == jniah.load_haystack(None, 3000)


def _texts():
    """The needle, the question, a haystack, the circuit's passkey sentence and
    the first two records of each tracked LongBench task (context and input)."""
    texts = [jniah.DEFAULT_NEEDLE, jniah.DEFAULT_QUESTION, jniah.procedural_haystack(4000, seed=3),
             " Remember this: the secret code of hazel is jade knoll lagoon. ",
             "\nQuestion: the secret code of hazel is", "Paragraph 7 holds one entry . 12 ?"]
    for path in sorted(LONGBENCH.glob("*.jsonl")):
        for line in path.read_text().splitlines()[:2]:
            rec = json.loads(line)
            texts += [rec["context"], rec["input"]]
    return texts


@pytest.mark.parametrize("kind,vocab", [("word", 512), ("word", 128256), ("byte", None)])
def test_tokenizer_ids_and_decodes_equal(kind, vocab):
    if kind == "word":
        t, j = ttok.WordTokenizer(vocab), jtok.WordTokenizer(vocab)
        assert t._vocab == j._vocab and t._hash_base == j._hash_base
    else:
        t, j = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    for text in _texts():
        ids = ttok.encode_ids(t, text)
        assert ids == jtok.encode_ids(j, text)
        assert ttok.decode_ids(t, ids) == jtok.decode_ids(j, ids)
        assert t.encode(text, add_bos=False) == j.encode(text, add_bos=False)
    if kind == "word":  # the inverse map that decodes hashed words
        assert t._inv == j._inv


def test_get_tokenizer_kinds():
    assert isinstance(ttok.get_tokenizer(None), ttok.ByteTokenizer)
    assert isinstance(ttok.get_tokenizer("byte"), ttok.ByteTokenizer)
    word = ttok.get_tokenizer("word")
    assert isinstance(word, ttok.WordTokenizer) and word.vocab_size == jtok.get_tokenizer("word").vocab_size


PAIRS = [
    ("the cat sat", "cat sat"), ("big cat sat", "cat sat"), ("a x b y c", "a b c"),
    ("jade knoll lagoon .", "jade knoll lagoon"), ("", "jade"), ("jade", ""),
    ("there are 7 paragraphs", "7"), ("maybe 3 or 4", "7"), ("Paragraph 12", "Paragraph 12"),
    ("I think 12, not 3", "Paragraph 12"), ("Location", "Location"), ("Location Person", "Location"),
    ("x = 1\n# comment", "x = 1"), ("```\ny = f(x)", "y = f(x)"),
    ("treasure under the old stone bridge", "under the old stone bridge in Harmony Creek"),
    ("今天天气很好，我们去公园。", "今天天气好，去公园"), ("段落3", "段落3"), ("我认为是段落12和5", "段落12"),
    ("北京是中国的首都", "中国首都是北京"),
]
SCORERS = ["f1_score", "rouge_l", "rouge_score", "qa_f1_score", "retrieval_score", "count_score",
           "code_sim_score", "edit_sim_score", "qa_f1_zh_score", "rouge_zh_score", "retrieval_zh_score",
           "niah_score", "word_overlap_score"]


@pytest.mark.parametrize("name", SCORERS)
def test_scorer_equal(name):
    for pred, gold in PAIRS:
        assert getattr(tM, name)(pred, gold) == getattr(jM, name)(pred, gold), (pred, gold)


def test_scorers_with_options_and_normalizers_equal():
    classes = ["Location", "Person", "jade", "knoll"]
    for pred, gold in PAIRS:
        assert tM.classification_score(pred, gold, all_classes=classes) == \
            jM.classification_score(pred, gold, all_classes=classes)
        for n in (1, 2):
            assert tM.rouge_n(pred, gold, n=n) == jM.rouge_n(pred, gold, n=n)
        assert tM.normalize_answer(pred) == jM.normalize_answer(pred)
        assert tM.normalize_zh_answer(pred) == jM.normalize_zh_answer(pred)


@pytest.mark.parametrize("kind", ["word", "byte"])
def test_passkey_samples_equal(kind):
    cfg_kw = dict(context_length_min=256, context_length_max=768, num_passkeys=3, passkey_length=3)
    tds = tdata.MultiPasskeyDataset(ttok.get_tokenizer(kind), tdata.PasskeyDataConfig(**cfg_kw), 50)
    jds = jdata.MultiPasskeyDataset(jtok.get_tokenizer(kind), jdata.PasskeyDataConfig(**cfg_kw), 50)
    np.testing.assert_array_equal(tds.context_lengths, jds.context_lengths)
    for idx in (0, 3, 60_001):
        t, j = tds[idx], jds[idx]
        for key in ("input_ids", "labels"):
            assert t[key].dtype == j[key].dtype
            np.testing.assert_array_equal(t[key], j[key])
        (tid, tans), (jid, jans) = tds.eval_prompt(idx, 1), jds.eval_prompt(idx, 1)
        np.testing.assert_array_equal(tid, jid)
        assert tans == jans
    tb = next(tdata.data_iterator(tds, 3, pad_to=832))
    jb = next(jdata.data_iterator(jds, 3, pad_to=832))
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(tb[key], jb[key])
    tc, jc = tdata.collate([tds[1], tds[2]]), jdata.collate([jds[1], jds[2]])
    np.testing.assert_array_equal(tc["input_ids"], jc["input_ids"])
