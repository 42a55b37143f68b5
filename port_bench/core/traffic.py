"""The one traffic generator: a mix's parameters and a seed -> its requests.

Every seed gets the same multiset of sizes and gaps (the quantiles of each
distribution at (i + 0.5) / n), in a uniformly random order of its own, and
token ids of its own, so runs with two seeds do the same amount of work in
another order. The order is not smoothed: long prompts may come in runs and
the open loop's gaps, an exchangeable draw of an exponential's quantiles,
bunch as a Poisson process's do, so the tails see the bursts users send.
A stream is endless: request k takes size k mod n of the permutation. A
mix's ``sizes`` sets n (``SIZES`` without it): about the requests one run
sends, warm phase and window, so every seed's run draws on one same set.

Distributions (a mix's JSON): ``{"dist": "loguniform" | "uniform", "min": a,
"max": b}`` for lengths (whole numbers, both ends included), and the
open loop's ``rate_rps`` for exponential gaps between arrivals.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

SIZES = 256  # sizes a stream holds before it repeats, where a mix does not say


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n stratified values of a length distribution, ascending, int64."""
    u = (np.arange(n) + 0.5) / n
    a, b = float(spec["min"]), float(spec["max"])
    if spec["dist"] == "loguniform":
        x = np.exp(math.log(a) + u * (math.log(b) - math.log(a)))
    elif spec["dist"] == "uniform":
        x = a + u * (b - a)
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(x), a, b).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """n stratified gaps (seconds) of a Poisson process at ``rate``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def _rng(seed: int, *parts: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *parts])


@dataclass
class Stream:
    """A serving mix under one seed: request k's prompt, output length and
    (open loop) due time since the stream's start."""

    seed: int
    vocab: int
    prompts: np.ndarray  # [n]
    outputs: np.ndarray  # [n]
    arrivals: np.ndarray  # [n] cumulative seconds of one pass; empty in a closed loop

    def prompt_len(self, k: int) -> int:
        return int(self.prompts[k % len(self.prompts)])

    def max_new(self, k: int) -> int:
        return int(self.outputs[k % len(self.outputs)])

    def prompt_ids(self, k: int) -> np.ndarray:
        """Token ids drawn uniformly from the vocabulary, int32."""
        return _rng(self.seed, 1, k).integers(0, self.vocab, size=self.prompt_len(k), dtype=np.int32)

    def due(self, k: int) -> float:
        n, period = len(self.arrivals), float(self.arrivals[-1])
        return (k // n) * period + float(self.arrivals[k % n])


def serving_stream(mix: dict, seed: int, vocab: int) -> Stream:
    """The stream of a serving mix (``prompt``, ``output``, ``sizes``, and
    ``rate_rps`` for an open loop) under ``seed``."""
    rng, n = _rng(seed, 0), int(mix.get("sizes", SIZES))
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    outputs = rng.permutation(quantiles(mix["output"], n))
    arrivals = np.empty(0)
    if "rate_rps" in mix:
        arrivals = np.cumsum(rng.permutation(exponential_gaps(float(mix["rate_rps"]), n)))
    return Stream(seed=seed, vocab=vocab, prompts=prompts, outputs=outputs, arrivals=arrivals)


def buckets(lo: int, hi: int, cap: int, first: int = 512) -> List[int]:
    """The power-of-two buckets (from ``first``, capped at ``cap``) that
    lengths from lo to hi fall in, ascending."""
    out, b = [], first
    while b < lo:
        b *= 2
    while True:
        out.append(min(b, cap))
        if b >= hi or b >= cap:
            return out
        b *= 2
