"""Share of a training step's device time in its backward pass, %: the
``train.backward`` spans' device time over the device time of every child
of a ``train.step`` span (``train.forward``, ``train.backward``,
``train.update``), over the traced steps."""

from port_bench.core import spans


def read(record):
    got = spans.profiled() or []
    steps = {s.id for s in got if s.name == "train.step"}
    kids = [s for s in got if s.parent in steps]
    if not kids or any(s.device_ms is None for s in kids):
        return None
    total = sum(s.device_ms for s in kids)
    back = sum(s.device_ms for s in kids if s.name == "train.backward")
    return 100.0 * back / total if total > 0 else None
