"""The control: the program in its W8A8 path (the next precision below the
configurations' bf16), read by the same check. At tiny sizes on the CPU it
must read wider than the bf16 program; on the card, at each cell's own size,
``port_bench/control.py`` gives the readings the limits were set from (it
runs there with ``-m cuda``, a few minutes a cell)."""

import pytest

from port_bench import control
from port_bench.core.harness import Context, load_json
from port_bench.reference.model import gaps, logits_at

from .conftest import ROOT


def test_w8a8_control_reads_wider_than_the_program_on_the_cpu(cpu_context):
    from port_bench.core import serve

    ctx = cpu_context("closed", seconds=1.5)
    outcome = serve.run_serving(ctx, closed=True, check=False)
    assert outcome.checks == []
    served = outcome.notes["served"]
    ctrl = control.control_tokens(ctx, served)
    logits = logits_at(ctx.conf, ctx.seed, served, "cpu")
    prog = max(float(gaps(lg, t).max()) for lg, (_, t) in zip(logits, served))
    ctl = max(float(gaps(lg, c).max()) for lg, c in zip(logits, ctrl))
    assert ctl > prog


@pytest.mark.parametrize("driver, read, want", [
    ("closed_loop", {"program": {"served_widest_gap": 0.1, "served_mean_gap": 0.01},
                     "control": {"served_widest_gap": 0.3, "served_mean_gap": 0.02}}, (True, False)),
    ("closed_loop", {"program": {"served_widest_gap": float("nan")}, "control": {"served_widest_gap": 0.1}},
     (False, True)),
    ("gate_train", {"program": {"loss_gap": 0.001, "grad_gap": 0.001, "change_gap": 0.001},
                    "control": {"loss_gap": 0.001, "grad_gap": 0.06, "change_gap": 0.001}}, (True, False)),
])
def test_judge_puts_each_reading_through_the_runs_rule(cpu_context, driver, read, want):
    ctx = cpu_context("train" if driver == "gate_train" else "closed")
    ctx.limits.clear()
    ctx.limits.update(served_widest_gap=0.2, train_loss_gap=0.016, train_grad_gap=0.024, train_change_gap=0.2)
    assert control.judge(ctx, read) == {"program": want[0], "control": want[1]}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(card, workload):
    """Three seeds at the cell's own size: the program reads within its
    limit, the control beyond it on at least one number."""
    import time

    for seed in (101, 202, 303):
        ctx = Context.build(ROOT, workload, seed, 20.0, False, time.monotonic())
        ctx.device = card
        if ctx.mix["driver"] == "gate_train":
            r = control.training_readings(ctx)
            assert all(r["program"][k] <= ctx.limits["train_" + k] for k in r["program"])
            assert any(r["control"][k] > ctx.limits["train_" + k] for k in r["control"])
        else:
            r = control.serving_readings(ctx)
            names = [n for n in r["program"] if n in ctx.limits]
            assert names and all(r["program"][n] <= ctx.limits[n] for n in names)
            assert any(r["control"][n] > ctx.limits[n] for n in names)
        assert control.judge(ctx, r) == {"program": True, "control": False}
