"""Synthesized LongBench-format task data in the circuit's passkey
grammar.

The port's own copy of duo_attention_tpu/evals/longbench_data.py:
``build_tasks()`` with its defaults writes the tracked
artifacts/longbench_tpu/data/*.jsonl byte for byte
(tests/test_torch_evals.py), which also holds the copied word lists and
haystack generator to the JAX package's.

No third-party corpora ship with this build, so records are generated in
the LongBench field format (context/input/answers/all_classes/length)
with GRADED difficulty (VERDICT r4 weak #1 — an all-solvable suite
cannot detect partial accuracy loss):

* "easy"      distinct names, disjoint codes — solvable by exact
              retrieval (ceiling rows).
* "dup_name"  the queried name appears twice with different codes that
              share their first word; gold = the first occurrence. Any
              retrieval mechanism sees two equal matches, so even full
              attention resolves only the shared word reliably.
* "overlap"   code words drawn from a small shared pool, so continuation
              chains can jump across keys mid-answer (partial n-gram
              credit under F1/ROUGE).
* "digit"     the code is the paragraph number; gold "Paragraph N"
              (the retrieval_score family, parsed for its number).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..train.data import _CODE_WORDS, _NAMES
from .niah import procedural_haystack


def _qa_frame(n, c, filler):
    return f"{filler}. Remember this: the secret code of {n} is {c}. "


def _dialogue_frame(n, c, filler):
    return (f"{filler}. Dialogue of {n} . "
            f"Remember this: the secret code of {n} is {c}. ")


def records(rng, n_samples, n_keys, key_len, seed0, mode="easy",
            framing=None, hay_chars=16000):
    framing = framing or _qa_frame
    recs = []
    for i in range(n_samples):
        names = list(rng.choice(_NAMES, size=n_keys, replace=False))
        if mode == "overlap":
            pool = rng.choice(_CODE_WORDS, size=6, replace=False)
            codes = [" ".join(rng.choice(pool, size=key_len))
                     for _ in range(n_keys)]
        elif mode == "digit":
            codes = [str(j + 1) for j in range(n_keys)]
        else:
            flat = rng.choice(_CODE_WORDS, size=n_keys * key_len,
                              replace=False)
            codes = [" ".join(flat[j * key_len:(j + 1) * key_len])
                     for j in range(n_keys)]
        qi = int(rng.integers(0, n_keys))
        if mode == "dup_name":
            # re-insert the queried name with a second code sharing the
            # first word; GOLD stays the first occurrence's code
            w = codes[qi].split()
            alt_pool = [c for c in _CODE_WORDS if c not in codes[qi]]
            alt = " ".join([w[0]] + list(
                rng.choice(alt_pool, size=key_len - 1, replace=False)))
            names.append(names[qi])
            codes.append(alt)
        hay = procedural_haystack(hay_chars, seed=seed0 + i).split(". ")
        parts = []
        for j, (n, c) in enumerate(zip(names, codes)):
            filler = ". ".join(hay[j * 18:(j + 1) * 18])
            if mode == "digit":
                parts.append(
                    f"{filler}. Paragraph {j + 1} holds one entry . "
                    f"Remember this: the secret code of {n} is {c} . ")
            else:
                parts.append(framing(n, c, filler))
        # >256 words of tail so no passkey lands inside the recent window
        k = len(names)
        parts.append(". ".join(hay[k * 18:k * 18 + 40]))
        answers = ([f"Paragraph {qi + 1}"] if mode == "digit"
                   else [codes[qi]])
        recs.append({
            "context": "".join(parts),
            "input": f"Question: the secret code of {names[qi]} is",
            "answers": answers,
            "all_classes": list(_CODE_WORDS) if key_len == 1 else [],
            "length": sum(len(p.split()) for p in parts),
        })
    return recs


def build_tasks(easy=8, hard=16, seed=7):
    """The 6-task suite of scripts/run_longbench_tpu.sh."""
    rng = np.random.default_rng(seed)
    return {
        # classification family — single-word codes (ceiling contrast)
        "trec": records(rng, easy, 3, 1, 700),
        "lsht": records(rng, easy, 3, 1, 900),
        # QA-F1 — graded: easy + duplicate-name ambiguous
        "triviaqa": (records(rng, easy, 3, 3, 300)
                     + records(rng, hard, 3, 3, 1300, mode="dup_name")),
        # ROUGE — graded: easy + overlapping-code records
        "samsum": (records(rng, easy, 3, 3, 500, framing=_dialogue_frame)
                   + records(rng, hard, 3, 3, 1500, mode="overlap")),
        # retrieval_score family — digit answers ("Paragraph N")
        "passage_retrieval_style": records(rng, easy, 6, 1, 1700,
                                           mode="digit"),
        # code_sim family — fuzzy line similarity on the code words
        "codecomp_style": records(rng, easy, 3, 3, 1900),
    }


def main(argv=None):
    import sys

    out_dir = (sys.argv[1:] if argv is None else argv)[0]
    os.makedirs(out_dir, exist_ok=True)
    tasks = build_tasks()
    for task, recs in tasks.items():
        with open(os.path.join(out_dir, f"{task}.jsonl"), "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    print("wrote", out_dir, {t: len(r) for t, r in tasks.items()})


if __name__ == "__main__":
    main()
