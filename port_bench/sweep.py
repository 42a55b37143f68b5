"""Find an open-loop cell's knee: the cell's mix at several fixed rates, one
window each, on the card. For each rate: requests due, completed a second,
the backlog at the window's close, and the end-to-end metrics.

    python3 port_bench/sweep.py --workload mistral-7b-v0.2.chat --rates 2,4,6,8 --seconds 20 --seed 7

The knee is the highest rate whose completions keep up with arrivals and
whose backlog does not grow; the cell's ``rate_rps`` is set to about four
fifths of it by hand, in its traffic file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="an open-loop cell's knee")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 3
    from port_bench.core.serve import run_serving

    for rate in (float(r) for r in args.rates.split(",")):
        ctx = harness.Context.build(ROOT, args.workload, args.seed, args.seconds, False, time.monotonic())
        ctx.device = torch.device("cuda", 0)
        ctx.mix["rate_rps"] = rate
        out = run_serving(ctx, closed=False)
        print(json.dumps({"rate_rps": rate, "due": out.attempted,
                          "completed_per_s": out.notes["finished_in_window"] / args.seconds,
                          "open_at_close": out.notes["open_at_close"],
                          "generator_late_s": out.notes["generator_late_s"],
                          **{k: v for k, v in out.e2e.items()}, "check": out.checks}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
