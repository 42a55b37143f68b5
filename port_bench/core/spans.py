"""The program's own spans (``duo_attention_tpu_torch.tracing``) for the
per-layer readers: the spans of the traced span's profiler session, and
where they lie on the reduced trace's timeline (``core/trace.py``).

The readers run in the driver's process after it returns, so the program's
recorder still holds the spans it recorded while the profiler ran. A
program without the recorder, or one that recorded nothing, gives None, and
so does every reader built on these."""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import trace


def profiled() -> Optional[list]:
    """The spans of this process's last profiler session, or None."""
    try:
        from duo_attention_tpu_torch import tracing
    except ImportError:
        return None
    got = [s for s in tracing.spans() if s.session is not None and s.t1 is not None]
    if not got:
        return None
    last = max(s.session for s in got)
    return [s for s in got if s.session == last]


def named(name: str) -> List:
    return [s for s in profiled() or [] if s.name == name]


def device_ms(name: str, count: str) -> Optional[float]:
    """Device ms of the spans called ``name`` over their ``count``, where
    each has its device time."""
    got = [s for s in named(name) if s.device_ms is not None]
    n = sum(s.counts[count] for s in got)
    return sum(s.device_ms for s in got) / n if n else None


def on_trace(rec: dict, spans: list, name: str) -> Optional[List[Tuple[float, float]]]:
    """The (start, end) us of the spans called ``name`` on ``rec``'s
    timeline, through the session's clock range among ``rec``'s host
    events; None without that range."""
    from duo_attention_tpu_torch import tracing

    clock = [(s, e) for n, s, e in rec["host"] if n == tracing.CLOCK]
    if not clock:
        return None
    off = tracing.offset_us(spans[0].session, *clock[0])
    if off is None:
        return None
    return [(s.t0 / 1e3 - off, s.t1 / 1e3 - off) for s in spans if s.name == name]


def idle_share_in(record, name: str) -> Optional[float]:
    """The device's idle time of the traced span (``trace._gaps``) that
    lies inside a span called ``name``, % of the span's wall time: 0 where
    the program recorded spans but none called ``name``."""
    tr = record.get("trace") if record else None
    spans = profiled()
    if not tr or tr["window_s"] <= 0 or not spans:
        return None
    inside = on_trace(tr, spans, name)
    if inside is None:
        return None
    idle = 0.0
    for a, b in trace._gaps(tr):
        for s, e in inside:
            idle += max(0.0, min(b, e) - max(a, s))
    return 100.0 * idle / 1e6 / tr["window_s"]
