"""Open-loop serving: requests arrive on a schedule (``rate_rps``, the
stream's stratified Poisson gaps) whether or not earlier ones finished. A
request is due at its scheduled arrival."""

from port_bench.core.serve import run_serving


def run(ctx):
    return run_serving(ctx, closed=False)
