"""The device's idle time inside the gate trainer's backward passes, % of
the traced span's wall time: the idle gaps of the profile (``trace._gaps``)
where they overlap a ``train.backward`` span, put on the profile's
timeline through the program's clock range. A part of
``device.idle_share.train`` of the same run."""

from port_bench.core import spans


def read(record):
    return spans.idle_share_in(record, "train.backward")
