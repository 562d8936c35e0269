"""Where the perception chain's device time goes, on one CUDA device.

  python -m airpose_tpu_torch.profile_chain [--trunk int8|int8_block|bf16] [--trace out.json]

Runs the perception chain (perception.perceive) with the chosen trunk
(default ``int8``, the bench's) at B = 64 frames under torch.profiler for 5
steps after a warm-up and prints one JSON line:
  - ``wall_ms``: CUDA-event time per chain step without the profiler, and
    ``wall_ms_profiled`` with it;
  - ``busy_ms``: summed device time of all kernels and copies per step (one
    stream, so they do not overlap) and ``idle_share`` = 1 − busy / wall_ms;
  - ``spans_ms``: device time per step of the kernels launched inside each
    record_function span of the chain (the trunk's own spans: stem, one
    kernel, and int8_layers for ``int8``; front and int8_layers for ``int8_block``;
    stem, layer1 and tail for ``bf16``; then ief, smplx, project), and each
    span's top kernels;
  - ``top_kernels``: the kernels with the most device time per step.
With ``--trace`` it also writes the profiler's Chrome trace to that file.
"""

import argparse
import json
import subprocess
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .perception import TRUNKS, bench_inputs, build_perception, perceive

B, STEPS = 64, 5
SPANS = ("stem", "front", "layer1", "tail", "int8_layers", "ief", "smplx", "project")
# The port's own kernels launch through ctypes, not through an aten op, so
# the profiler's tree does not place them under a span: attribute by name.
# Both int8 trunks launch the int8 conv kernel only in their int8_layers span;
# the int8 trunk's stem span is one launch of the fused stem kernel (conv,
# max-pool, bias and relu).
OWN_KERNELS = {"bottleneck_kernel": "layer1", "skinning_kernel": "smplx",
               "int8_conv_kernel": "int8_layers", "fused_stem_kernel": "stem"}


def _span_kernels(span):
    """(kernel name, µs) of every kernel launched under a CPU-side span."""
    out, stack = [], [span]
    while stack:
        e = stack.pop()
        out.extend((k.name, k.duration) for k in e.kernels)
        stack.extend(e.cpu_children)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trunk", choices=TRUNKS, default="int8")
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args(argv)
    model, smplx_params, features = build_perception(trunk=args.trunk)
    inputs = bench_inputs(B)
    for _ in range(3):
        perceive(model, smplx_params, *inputs, features)
    torch.cuda.synchronize()

    def timed_steps():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(STEPS):
            perceive(model, smplx_params, *inputs, features)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / STEPS

    wall_ms = timed_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms_profiled = timed_steps()

    events = prof.events()
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / STEPS
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            per_kernel = spans.setdefault(e.name, {})
            for name, us in _span_kernels(e):
                per_kernel[name] = per_kernel.get(name, 0.0) + us / 1e3 / STEPS
    totals = defaultdict(float)
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3 / STEPS
        totals[e.name] += ms
        for own, span in OWN_KERNELS.items():
            if own in e.name:
                per_kernel = spans.setdefault(span, {})
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) + ms
    print(json.dumps({
        "batch": B,
        "trunk": args.trunk,
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[:1],
        "wall_ms": wall_ms,
        "wall_ms_profiled": wall_ms_profiled,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "two_view_fps": B / (wall_ms / 1e3),
        "spans_ms": {k: sum(v.values()) for k, v in spans.items()},
        "span_top_kernels": {
            k: [{"name": n[:100], "ms": ms} for n, ms in
                sorted(v.items(), key=lambda kv: -kv[1])[:6]]
            for k, v in spans.items()},
        "top_kernels": [{"name": n[:100], "ms": ms} for n, ms in
                        sorted(totals.items(), key=lambda kv: -kv[1])[:12]],
    }))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
