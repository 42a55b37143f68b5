"""Closed-loop serving: ``clients`` clients, each sending its next request
the moment its last one finished (no think time), into a pool of
``slots`` slots. A request is due when its client sent it."""

from port_bench.core.serve import run_serving


def run(ctx):
    return run_serving(ctx, closed=True)
