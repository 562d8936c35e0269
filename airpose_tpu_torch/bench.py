"""Two-view perception throughput of the port on one CUDA device.

Runs the bf16 perception chain (perception.perceive: fused-layer1 trunk,
3-step IEF, 6D → rotmat, full SMPL-X forward with the skinning kernel, 2D
projection) at batch 64 and prints ONE JSON line, as the root bench.py:
  {"metric": "two_view_fps", "value": N, "unit": "frames/s",
   "vs_baseline": N / 1000, "repeats": 5, "min": .., "max": ..,
   "spread_pct": .., "device": "<name>"}
Each repeat times ``ITERS`` chain calls between two CUDA events after a
warm-up; the value is the median of the repeats.

  python -m airpose_tpu_torch.bench
"""

import json
import statistics
from typing import List

import torch

from .perception import bench_inputs, build_perception, perceive

B = 64
ITERS = 10
REPEATS = 5


def two_view_fps(model, smplx_params, stage_ops, inputs, iters: int = ITERS,
                 repeats: int = REPEATS, warmup: int = 2) -> List[float]:
    """Frames per second of each repeat, timed with CUDA events."""
    images = inputs[0]
    if images.device.type != "cuda":
        raise RuntimeError("two_view_fps times a CUDA device")
    for _ in range(warmup):
        perceive(model, smplx_params, *inputs, stage_ops=stage_ops)
    fps = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            verts, j2d = perceive(model, smplx_params, *inputs, stage_ops=stage_ops)
        stop.record()
        stop.synchronize()
        if not (torch.isfinite(verts).all() and torch.isfinite(j2d).all()):
            raise RuntimeError("non-finite perception output")
        fps.append(images.shape[0] * iters / (start.elapsed_time(stop) / 1e3))
    return fps


def main():
    model, smplx_params, stage_ops = build_perception()
    inputs = bench_inputs(B)
    runs = two_view_fps(model, smplx_params, stage_ops, inputs)
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
    }))


if __name__ == "__main__":
    main()
