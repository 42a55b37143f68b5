"""Scoring metrics for NIAH and LongBench — protocol-faithful.

The port's own copy of duo_attention_tpu/evals/metrics.py (pure Python; the
port imports nothing of the JAX package), held equal to it scorer by scorer
by tests/test_torch_tokenizer_metrics.py.

Provides the metric semantics of the reference's scorers
(eval/LongBench/metrics.py, eval/needle ROUGE usage): unigram ROUGE,
token-level QA F1, substring classification/retrieval/count scores,
edit-distance code similarity, and the jieba-segmented Chinese variants.
Formulas follow the public metric definitions (Lin 2004 ROUGE; SQuAD F1;
the LongBench-standard classification/retrieval/count protocols, which
are kept semantically identical for score comparability); the
implementations are this repo's own (LCS DP, difflib SequenceMatcher).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from difflib import SequenceMatcher
from typing import Iterable, List


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace (SQuAD-style)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _tokens(s: str) -> List[str]:
    return normalize_answer(s).split()


def _f1_from_tokens(pred: List[str], gold: List[str]) -> float:
    if not pred or not gold:
        return float(pred == gold)
    common = Counter(pred) & Counter(gold)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred)
    recall = overlap / len(gold)
    return 2 * precision * recall / (precision + recall)


def f1_score(prediction: str, ground_truth: str) -> float:
    """Token-level F1 between normalized strings."""
    return _f1_from_tokens(_tokens(prediction), _tokens(ground_truth))


def rouge_n(prediction: str, reference: str, n: int = 1) -> float:
    """ROUGE-N f-measure on normalized unigram/bigram multisets."""

    def ngrams(toks):
        return Counter(tuple(toks[i : i + n]) for i in range(len(toks) - n + 1))

    p, r = _tokens(prediction), _tokens(reference)
    gp, gr = ngrams(p), ngrams(r)
    if not gp or not gr:
        return 0.0
    overlap = sum((gp & gr).values())
    if overlap == 0:
        return 0.0
    prec = overlap / sum(gp.values())
    rec = overlap / sum(gr.values())
    return 2 * prec * rec / (prec + rec)


def _rouge_l_tokens(p: List[str], r: List[str]) -> float:
    if not p or not r:
        return 0.0
    # LCS length by DP over token sequences
    dp = [0] * (len(r) + 1)
    for tok in p:
        prev = 0
        for j, rt in enumerate(r, start=1):
            cur = dp[j]
            dp[j] = prev + 1 if tok == rt else max(dp[j], dp[j - 1])
            prev = cur
    lcs = dp[-1]
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(r)
    return 2 * prec * rec / (prec + rec)


def rouge_l(prediction: str, reference: str) -> float:
    """ROUGE-L f-measure via longest common subsequence of tokens."""
    return _rouge_l_tokens(_tokens(prediction), _tokens(reference))


def rouge_score(prediction: str, ground_truth: str) -> float:
    """LongBench 'rouge' metric: ROUGE-L f-measure."""
    return rouge_l(prediction, ground_truth)


def qa_f1_score(prediction: str, ground_truth: str) -> float:
    return f1_score(prediction, ground_truth)


def classification_score(prediction: str, ground_truth: str, all_classes=None) -> float:
    """Exact-class credit: ground-truth class named in the prediction,
    discounted by other mentioned classes."""
    em_match_list = []
    all_classes = all_classes or []
    for class_name in all_classes:
        if class_name in prediction:
            em_match_list.append(class_name)
    for match_term in list(em_match_list):
        if match_term in ground_truth and match_term != ground_truth:
            em_match_list.remove(match_term)
    if ground_truth in em_match_list:
        return 1.0 / len(em_match_list)
    return 0.0


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    """Paragraph-retrieval: does the predicted text name the gold paragraph
    number?"""
    pattern = r"Paragraph (\d+)"
    matches = re.findall(pattern, ground_truth)
    gold = matches[0] if matches else normalize_answer(ground_truth)
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if n == gold)
    return right / len(numbers) if numbers else 0.0


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers) if numbers else 0.0


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    """Line-level fuzzy similarity for code completion tasks."""
    all_lines = prediction.lstrip("\n").split("\n")
    prediction = ""
    for line in all_lines:
        if ("`" not in line) and ("#" not in line) and ("//" not in line):
            prediction = line
            break
    return SequenceMatcher(None, prediction, ground_truth).ratio()


def edit_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    return SequenceMatcher(None, prediction, ground_truth).ratio()


# ---------------------------------------------------------------------------
# Chinese-task scorers (LongBench zh tasks: multifieldqa_zh -> qa_f1_zh,
# dureader/vcsum -> rouge_zh, passage_retrieval_zh -> retrieval_zh;
# reference mapping eval/LongBench/eval.py:18-40, scorers metrics.py:32-46,
# 120-124,147-154). Word segmentation uses jieba, as the reference does;
# a character-level fallback keeps scoring functional without it.
# ---------------------------------------------------------------------------

_ZH_PUNCT = (
    "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～"
    "｟｠｢｣､、〃》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿"
    "–—‘’‛“”„‟…‧﹏."
)


def normalize_zh_answer(s: str) -> str:
    """Lowercase, strip Chinese + ASCII punctuation, drop ALL whitespace
    (Chinese text carries no meaningful spaces)."""
    drop = set(string.punctuation) | set(_ZH_PUNCT)
    s = "".join(ch for ch in s.lower() if ch not in drop)
    return "".join(s.split())


def _zh_segment(s: str) -> List[str]:
    try:
        import jieba

        return list(jieba.cut(s, cut_all=False))
    except ImportError:  # pragma: no cover - jieba is in the base env
        return list(s)


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    """Token F1 over jieba segments, each normalized, empties dropped."""

    def toks(s):
        out = (normalize_zh_answer(t) for t in _zh_segment(s))
        return [t for t in out if t]

    return _f1_from_tokens(toks(prediction), toks(ground_truth))


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    """ROUGE-L f-measure over jieba segments."""
    return _rouge_l_tokens(_zh_segment(prediction), _zh_segment(ground_truth))


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    """Chinese paragraph retrieval: gold id parsed from the 段落N label."""
    matches = re.findall(r"段落(\d+)", ground_truth)
    gold = matches[0] if matches else normalize_zh_answer(ground_truth)
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if n == gold)
    return right / len(numbers) if numbers else 0.0


def niah_score(response: str, needle_answer: str) -> float:
    """NIAH cell score: unigram ROUGE recall-oriented f-measure x10,
    matching the reference's rouge-1 x10 protocol
    (eval/needle/needle_in_haystack.py:320)."""
    return rouge_n(response, needle_answer, n=1) * 10.0


def word_overlap_score(response: str, expected: str) -> float:
    """Fraction of expected answer words present in the response (the
    visualization scorer, eval/needle/visualize.py)."""
    exp = set(_tokens(expected))
    if not exp:
        return 0.0
    got = set(_tokens(response))
    return len(exp & got) / len(exp)
