"""Spans and counters of the port's phases, on the profiler's clock.

A span is one phase of the program: a scheduler iteration, an admission
chunk, a decode burst, a training step and its parts, an eager activation
quantization of the W8A8 path (``ops/quant.py``). It holds its name,
its host start and end (``time.time_ns()``, the Unix-epoch nanoseconds the
torch profiler stamps its events in), the span it opened inside, the
request it belongs to (``rid``), a small dict of counts and, optionally,
its device milliseconds: two timing events recorded on the current stream,
read at the next point where the host waits anyway (``resolve()``, called
after a decode burst's tokens and a training step's loss reach the host)
or when the spans are read. The recorder never synchronizes and never
copies from the device. A span carries only the counts and device time
that a reader of it uses.

It records only while a torch profiler runs, or inside ``recording()``.
Otherwise ``span()`` costs one flag check and returns ``NULL``, which
records nothing and is false, so a caller computes its counts only under
``if sp:``. A caller that needs the host stamps for itself (the serving
engine's ``timing=True``) opens the span with ``keep=True``: it is then
stamped, but enters the buffer only when recording. No span opens inside a
captured CUDA graph: spans sit around bursts, never around a replay.

The clock anchor: the first span of each profiler session opens and
closes one empty ``record_function(CLOCK)`` and keeps its own stamps from
just before and just after it. A reader finds that host event in the
profile and gets the offset between the two clocks for that profiler
session (``offset_us``). It launches nothing, so it has no copy on the
device timeline. A session starts where torch's profiler raises its
enabled flag (``_run_on_profiler_start``), which the recorder wraps to
count sessions, so back-to-back sessions each get their own anchor.

    from duo_attention_tpu_torch import tracing
    with tracing.recording():
        engine.run()
    for sp in tracing.spans():
        print(sp.name, sp.parent, sp.counts, sp.device_ms)
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

CLOCK = "duo.trace.clock"
MAXLEN = 65536  # spans kept, newest last

_buffer: collections.deque = collections.deque(maxlen=MAXLEN)
_stack: List["Span"] = []  # recorded spans still open, innermost last
_pending: List["Span"] = []  # recorded spans whose device time is not read yet
_ids = itertools.count(1)
_forced = 0  # depth of recording() contexts
_session = 0  # profiler sessions started so far
_anchored = -1  # the last session given its anchor (0: one started before this module)
_anchors: Dict[int, Tuple[int, int]] = {}  # session -> host ns just before and after the CLOCK range


class Span:
    """One phase. ``t0``/``t1``: host ns (``t1`` None while open); ``parent``:
    the id of the recorded span it opened inside, or None; ``session``: the
    profiler session it was recorded in (None under ``recording()`` alone);
    ``device_ms``: None until read, and on the CPU."""

    __slots__ = ("name", "id", "parent", "rid", "counts", "t0", "t1", "device_ms", "session", "recorded",
                 "_dev", "_ev0", "_ev1")

    def __init__(self, name: str, rid: Optional[int] = None, counts: Optional[dict] = None,
                 recorded: bool = False, session: Optional[int] = None, device=None):
        self.name, self.rid, self.counts = name, rid, dict(counts or {})
        self.id = next(_ids)
        self.parent = _stack[-1].id if _stack else None
        self.recorded, self.session = recorded, session
        self.device_ms, self.t1 = None, None
        self._dev, self._ev0, self._ev1 = device, None, None
        if recorded:
            _stack.append(self)
        self.t0 = time.time_ns()

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, rid={self.rid}, "
                f"counts={self.counts}, device_ms={self.device_ms})")

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def set(self, **counts) -> None:
        self.counts.update(counts)

    def device_start(self) -> None:
        """Record the device start now (the span's open, unless called)."""
        if self._dev is not None:
            self._ev0 = _event(self._dev)

    def device_end(self) -> None:
        """Record the device end now (the span's close, unless called
        first)."""
        if self._ev0 is not None and self._ev1 is None:
            self._ev1 = _event(self._dev)

    def close(self) -> None:
        if self.t1 is not None:
            return
        self.device_end()
        self.t1 = time.time_ns()
        if not self.recorded:
            return
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            _stack.remove(self)
        _buffer.append(self)
        if self._ev1 is not None:
            _pending.append(self)
            if len(_pending) >= 4096:
                resolve()


class _Null:
    """The span of a phase that is not recorded: false, and does nothing."""

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **counts) -> None:
        pass

    def device_start(self) -> None:
        pass

    def device_end(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _Null()


def _event(device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _anchor() -> None:
    global _anchored
    before = time.time_ns()
    with _profiler.record_function(CLOCK):
        pass
    _anchors[_session] = (before, time.time_ns())
    _anchored = _session


def _session_started(start=_profiler._run_on_profiler_start):
    """torch's profiler calls this as each session starts (``profile.
    _start_trace``): count the session, then raise torch's flag."""
    global _session
    _session += 1
    start()


_profiler._run_on_profiler_start = _session_started


def active() -> bool:
    """Whether spans are recorded now."""
    return _forced > 0 or _profiler._is_profiler_enabled


def span(name: str, rid: Optional[int] = None, keep: bool = False, device=None, device_now: bool = True,
         **counts):
    """Open a span (a context manager; ``close()`` ends it too). ``device``:
    the CUDA device whose current stream the device time is taken on (None,
    or a CPU device: no device time); ``device_now=False`` leaves the
    device start to ``device_start()``. Returns ``NULL`` unless recording
    or ``keep``."""
    if _profiler._is_profiler_enabled:
        if _anchored != _session:
            _anchor()
        recorded, session = True, _session
    else:
        recorded, session = _forced > 0, None
        if not (recorded or keep):
            return NULL
    dev = None
    if recorded and device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
    sp = Span(name, rid, counts, recorded, session, dev)
    if device_now:
        sp.device_start()
    return sp


@contextlib.contextmanager
def recording():
    """Record spans inside this context, profiler or not."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def resolve() -> None:
    """Read the device time of every recorded span whose end has run on the
    device (``Event.query``, which does not wait); the rest stay pending."""
    keep = []
    for sp in _pending:
        if sp._ev1.query():
            sp.device_ms = sp._ev0.elapsed_time(sp._ev1)
            sp._ev0 = sp._ev1 = None
        else:
            keep.append(sp)
    _pending[:] = keep


def spans() -> List[Span]:
    """The recorded spans, oldest first (device times read where they
    have run)."""
    resolve()
    return list(_buffer)


def clear() -> None:
    _buffer.clear()
    _pending.clear()


def offset_us(session: int, clock_start_us: float, clock_end_us: float) -> Optional[float]:
    """The offset, in us, to subtract from a span's host us (``t0 / 1e3``) to
    put it on a profile's timeline, given where that profile placed the
    session's CLOCK range (its start and end, us): the midpoints of the
    range and of the two stamps around it are the same instant."""
    a = _anchors.get(session)
    if a is None:
        return None
    return (a[0] + a[1]) / 2e3 - (clock_start_us + clock_end_us) / 2
