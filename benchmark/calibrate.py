"""Readings that the limits of ``correct`` are set from, several seeds in one
process (set-up is paid per seed, the process start once).

  python3 -m benchmark.calibrate --workload <cell> --seeds 11 12 13 [--seconds 2]
      [--control int4|int8] [--fault half_batch] [--out readings.jsonl]

For each seed it runs the cell as ``benchmark.run`` does, with a short
window, and prints one JSON line: the seed, the numbers compared (and the
end-to-end metrics and peak memory, for orientation). ``--control`` puts
the configuration's next lower precision in the program's place: the
plain reference at int4 for the int8 perception cell, the program's own
int8 quantization-aware path (``TrainConfig(qat=True)``) for the bf16
training cells. ``--fault half_batch`` feeds the training step half of
each batch. Neither is a benchmark run: they read the upper ends of the
limits.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .run import CACHES, CHECKOUT  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("int4", "int8"))
    ap.add_argument("--fault", choices=("half_batch",))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "build" / "bench_cache" / sub)

    import torch

    from . import harness

    c = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    t = T_START
    for seed in args.seeds:
        ctx = harness.Context(cell=c, seed=seed, device=torch.device("cuda", 0),
                              sizes=harness.sizes(c), control=args.control, fault=args.fault)
        r = harness.run(ctx, args.seconds, False, t)
        line = json.dumps({"workload": c.name, "seed": seed, "control": args.control,
                           "fault": args.fault,
                           "checks": {k: v["value"] for k, v in r["checks"].items()},
                           "details": r["_details"],
                           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                           "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
