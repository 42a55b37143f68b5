"""Device milliseconds a decode step: the ``serve.decode`` spans' device
time (timing events on the stream from before a burst's first step to after
its last token's copy) over their steps. The program's own spans
(``duo_attention_tpu_torch.tracing``), recorded while the profiler ran.

What the host stamp (``engine.decode_step_ms``) cannot show: the stream's
own time for the burst, apart from device work queued before it. The host
stamp is the burst's only because ``timing=True`` synchronizes after each
mid-prompt admission chunk; without that synchronize the chunk's queued
work lands in the host stamp, but not between these events. The two agree
while the synchronize stays, which is what lets a later benchmark change
drop it."""

from port_bench.core import spans


def read(record):
    return spans.device_ms("serve.decode", "steps")
