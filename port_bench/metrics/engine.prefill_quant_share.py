"""Share of admission prefill's device time spent quantizing activations,
%: the ``engine.quantize_act`` spans (each eager per-token int8 rounding
of a projection's input, ``ops/quant.py``) recorded inside
``engine.prefill_chunk`` spans, over those chunks' device time. Both from
the program's CUDA timing events, recorded while the profiler ran. None
where the program records no such span."""

from port_bench.core import spans


def read(record):
    chunks = {s.id: s.device_ms for s in spans.named("engine.prefill_chunk") if s.device_ms is not None}
    quant = [s.device_ms for s in spans.named("engine.quantize_act") if s.parent in chunks and s.device_ms is not None]
    total = sum(chunks.values())
    return 100.0 * sum(quant) / total if quant and total > 0 else None
