"""Run one cell of the benchmark once.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell (weights, body model and
inputs made on the device from the seed, kernels built or loaded from the
checkout's cache, the cell's shapes warmed up), measures for ``--seconds``,
checks the timed path's outputs against the plain reference, and prints
the comparisons on standard error and one JSON line as the last line of
standard output. ``--trace 1`` adds a traced window and reports the
per-layer metrics instead of the end-to-end ones. It exits non-zero, with
no result, without the CUDA devices the cell asks for or when the run has
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():   # fixed directories inside the checkout
        os.environ[var] = str(CHECKOUT / "build" / "bench_cache" / sub)
    try:
        from . import harness
    except ImportError as e:
        print(f"benchmark: cannot import the system under test: {e}", file=sys.stderr)
        return 2
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
