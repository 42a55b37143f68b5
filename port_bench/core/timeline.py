"""End-to-end arithmetic on the benchmark's own host clock.

A request's timeline: when it was due (its scheduled arrival in an open
loop; when its client sent it in a closed loop) and each time the
benchmark's loop saw new tokens of it, with how many. From those:

- ``ttft_p90_ms``: over every request due in the window, from due to the
  first token seen; a request with no first token by the window's close
  counts at the wait it has had so far.
- ``tpot_p90_ms``: over every request whose tokens were seen at two or more
  times inside the window, (last seen - first seen) / the tokens seen after
  the first sighting. A burst delivers several tokens at once, and those of
  the first sighting were made before the interval began, so they are not
  counted against it.
- ``output_tokens_per_s``: every token seen in the window over its seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class Timeline:
    due: float
    seen: List[Tuple[float, int]] = field(default_factory=list)  # (time, new tokens)

    def first_token(self) -> Optional[float]:
        return self.seen[0][0] if self.seen else None


def serving_metrics(lines: Dict[int, Timeline], w0: float, w1: float) -> dict:
    """The three serving metrics over the window [w0, w1], with the sample
    counts behind each percentile."""
    ttft = []
    for tl in lines.values():
        if not (w0 <= tl.due < w1):
            continue
        first = tl.first_token()
        ttft.append(((first if first is not None and first <= w1 else w1) - tl.due) * 1e3)
    tpot, tokens = [], 0
    for tl in lines.values():
        inside = [(t, n) for t, n in tl.seen if w0 <= t <= w1]
        tokens += sum(n for _, n in inside)
        if len(inside) >= 2:
            after_first = sum(n for _, n in inside[1:])
            tpot.append((inside[-1][0] - inside[0][0]) * 1e3 / after_first)
    out = {"output_tokens_per_s": tokens / (w1 - w0), "ttft_samples": len(ttft), "tpot_samples": len(tpot)}
    if ttft:
        out["ttft_p90_ms"] = percentile(ttft, 0.9)
    if tpot:
        out["tpot_p90_ms"] = percentile(tpot, 0.9)
    return out


def train_metrics(steps: Sequence[Tuple[float, float, int]], w0: float) -> dict:
    """steps: (start, end, tokens) of each step begun in the window, every
    one run whole. Tokens over the time from w0 to the last step's end."""
    if not steps:
        return {}
    end = max(e for _, e, _ in steps)
    return {"train_tokens_per_s": sum(n for _, _, n in steps) / (end - w0), "steps": len(steps)}
