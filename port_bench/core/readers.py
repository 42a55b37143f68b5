"""Sums over a traced serving span that several per-layer readers share."""

from __future__ import annotations

from . import counts


def decode_bursts(record):
    return [it["decode"] for it in record.get("iters", []) if it["decode"]]


def admit_chunks(record):
    return [it["admit"] for it in record.get("iters", []) if it["admit"]]


def step_lengths(burst):
    """Each decode step's rows' positions: the rows' lengths at the burst's
    start, plus the steps before it."""
    return [[n + t for n in burst["lengths"]] for t in range(burst["steps"])]


def decode_steps(record) -> int:
    return sum(b["steps"] for b in decode_bursts(record))


def decode_flops(record) -> float:
    m = record["model"]
    return sum(counts.decode_step_flops(m, ls) for b in decode_bursts(record) for ls in step_lengths(b))
