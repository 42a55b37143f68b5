"""The device's idle share of the traced span, %: 1 - busy / wall, busy the
time in which some device activity ran (the profiler's trace). An upper
bound: the profiler's own host cost lengthens the wall."""


def read(record):
    tr = record.get("trace") if record else None
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
