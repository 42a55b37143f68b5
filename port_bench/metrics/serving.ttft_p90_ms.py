"""The traced run's time to first token at the 90th percentile, ms: the
same host-clock arithmetic as the end-to-end metrics (``core/timeline.py``),
over the requests due in the traced run's window.

Not an end-to-end metric: over one window it swings by 20-30% between seeds
(a closed loop's queue behind admission, an open loop's bursts), more than
any bound can hold, so it is kept here, unbounded, beside the per-layer
numbers of the scheduler that sets it. Admission chunks sit between decode
bursts, so what shortens them moves ``tpot_p90_ms`` too. Closed loops only:
the engine's stamps synchronize after each chunk, which slows the traced
run's admission, and an open loop near its knee then queues far past what
an untraced run sees."""


def read(record):
    if not record:
        return None
    return record.get("ttft_p90_ms")
