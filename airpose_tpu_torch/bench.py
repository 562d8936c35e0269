"""Two-view perception throughput of the port on one CUDA device.

Runs the perception chain (perception.perceive: trunk, 3-step IEF, 6D →
rotmat, full SMPL-X forward with the skinning kernel, 2D projection) at
batch 64 and prints ONE JSON line, as the root bench.py:
  {"metric": "two_view_fps", "value": N, "unit": "frames/s",
   "vs_baseline": N / 1000, "repeats": 5, "min": .., "max": ..,
   "spread_pct": .., "device": "<name>", "trunk": "int8" | "bf16"}
The trunk is the int8 PTQ trunk, calibrated on the first frame's two
crops, as in the root bench; ``AIRPOSE_BENCH_BF16=1`` runs the bf16 trunk
with the fused layer1 kernel instead. Each repeat times ``ITERS`` chain
calls between two CUDA events after a warm-up; the value is the median of
the repeats.

  python -m airpose_tpu_torch.bench
"""

import json
import os
import statistics
from typing import List

import torch

from .perception import bench_inputs, build_perception, perceive

B = 64
ITERS = 10
REPEATS = 5


def two_view_fps(model, smplx_params, features, inputs, iters: int = ITERS,
                 repeats: int = REPEATS, warmup: int = 2) -> List[float]:
    """Frames per second of each repeat, timed with CUDA events."""
    images = inputs[0]
    if images.device.type != "cuda":
        raise RuntimeError("two_view_fps times a CUDA device")
    for _ in range(warmup):
        perceive(model, smplx_params, *inputs, features)
    fps = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            verts, j2d = perceive(model, smplx_params, *inputs, features)
        stop.record()
        stop.synchronize()
        if not (torch.isfinite(verts).all() and torch.isfinite(j2d).all()):
            raise RuntimeError("non-finite perception output")
        fps.append(images.shape[0] * iters / (start.elapsed_time(stop) / 1e3))
    return fps


def main():
    trunk = "bf16" if os.environ.get("AIRPOSE_BENCH_BF16") else "int8"
    model, smplx_params, features = build_perception(trunk=trunk)
    inputs = bench_inputs(B)
    runs = two_view_fps(model, smplx_params, features, inputs)
    fps = statistics.median(runs)
    print(json.dumps({
        "metric": "two_view_fps",
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / 1000.0, 3),
        "repeats": len(runs),
        "min": round(min(runs), 1),
        "max": round(max(runs), 1),
        "spread_pct": round(100.0 * (max(runs) - min(runs)) / fps, 2),
        "device": torch.cuda.get_device_name(0),
        "trunk": trunk,
    }))


if __name__ == "__main__":
    main()
