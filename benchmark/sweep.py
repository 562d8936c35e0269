"""Find the highest offered rate a served cell sustains: one set-up, then a
window at each rate, in one process.

  python3 -m benchmark.sweep --workload serve_pair_int8 --rates 20 30 40 50 --seconds 10

For each rate it prints one JSON line: the frames due and unanswered, the
p50 and p95 latency from the due times, the median latency of the
window's first and second halves (a queue that grows shows as a second
half slower than the first) and how late the generator sent. The cell's
rate is set once from this, at four fifths of the highest sustained rate.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .run import CACHES, CHECKOUT  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "build" / "bench_cache" / sub)

    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    ctx = harness.Context(cell=c, seed=args.seed, device=torch.device("cuda", 0),
                          sizes=harness.sizes(c))
    drv = harness.driver(c.traffic["driver"])
    ctx.phases = {"start": T_START}
    state = drv.setup(ctx)
    try:
        for rate in args.rates:
            ctx.sizes["rate"] = rate
            w = drv.window(ctx, state, args.seconds)
            print(json.dumps({"rate": rate, "due": w.attempted, "unanswered": w.failed,
                              "p95_ms": w.metrics["frame_latency_p95_ms"], **state.window,
                              "frames": None}), flush=True)
    finally:
        drv.shutdown(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
