"""The device's idle time inside the scheduler's decode bursts, % of the
traced span's wall time: the idle gaps of the profile (``trace._gaps``)
where they overlap a ``serve.decode`` span (the host's work between graph
replays, and its wait for the burst's tokens), put on the profile's
timeline through the program's clock range. A part of
``device.idle_share.*`` of the same run."""

from port_bench.core import spans


def read(record):
    return spans.idle_share_in(record, "serve.decode")
