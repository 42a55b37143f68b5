"""The device's idle time inside the scheduler's admission chunks, % of the
traced span's wall time: the idle gaps of the profile (``trace._gaps``)
where they overlap a ``serve.admit`` span, put on the profile's timeline
through the program's clock range. With ``device.idle_in_decode`` it splits
``device.idle_share.*`` of the same run; what neither holds is idle while
the host is between the program's phases or outside the program (the
benchmark's loop, or an open loop waiting for arrivals)."""

from port_bench.core import spans


def read(record):
    return spans.idle_share_in(record, "serve.admit")
