"""Where the int8 conv kernel's time goes in the int8 trunk, on one CUDA device.

  python -m airpose_tpu_torch.profile_convs

Captures the 52 convs of one static int8 trunk call at B = 64 frames (128
crops of 224², the bench's batch), replays them under torch.profiler and
prints one JSON line: the card, the kernel's device ms per trunk pass, and
for each class of conv (output size, kernel size and stride, channels,
output mode) the number of convs, their device ms and their bound ms, the
larger of the bytes they must move over 3.35 TB/s and their operations
over 1,979 TOPS (``ops.int8_conv.conv_cost``, as ``chip_smoke.py`` counts).
"""

import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .ops import int8_conv as ic
from .ops.int8_trunk import resnet50_int8_infer
from .perception import bench_inputs, build_perception

B, REPLAYS = 64, 3
HBM_BYTES_PER_S, INT8_OP_PER_S = 3.35e12, 1979e12  # H100 SXM at 700 W, data sheet


def conv_class(x, w, ksize, stride, kw) -> str:
    """e.g. "28x28 1x1/1 128->512 bf16+int8 res"."""
    ho = ic.out_size(x.shape[1], ksize, stride)
    out = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "f32"}[kw["out_dtype"]]
    if kw.get("qscale") is not None and kw["out_dtype"] == torch.bfloat16:
        out = "bf16+int8"
    res = " res" if kw.get("res") is not None else ""
    return f"{ho}x{ho} {ksize}x{ksize}/{stride} {x.shape[3]}->{w.shape[0]} {out}{res}"


def main():
    model, _, features = build_perception(trunk="int8")
    qparams, scales = features.args[0], features.keywords["act_scales"]
    images = bench_inputs(B)[0]
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ic.int8_conv(*a, **kw)

    with torch.no_grad():
        resnet50_int8_infer(qparams, images.reshape((B * 2,) + images.shape[2:]), scales,
                            conv=record)
    for a, kw in calls:  # warm-up
        ic.int8_conv(*a, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPLAYS):
            for a, kw in calls:
                ic.int8_conv(*a, **kw)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "int8_conv_kernel" in e.name]
    if len(events) != REPLAYS * len(calls):
        raise RuntimeError(f"{len(events)} kernel events for {REPLAYS} × {len(calls)} launches")
    classes = {}
    for i, e in enumerate(events):
        (x, w, _, _, ksize, stride), kw = calls[i % len(calls)]
        c = classes.setdefault(conv_class(x, w, ksize, stride, kw),
                               {"convs": 0, "ms": 0.0, "bound_ms": 0.0})
        c["ms"] += e.time_range.elapsed_us() / 1e3 / REPLAYS
        if i < len(calls):
            ops, n_bytes = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                                        kw.get("qscale"))
            c["convs"] += 1
            c["bound_ms"] += max(n_bytes / HBM_BYTES_PER_S, ops / INT8_OP_PER_S) * 1e3
    print(json.dumps({
        "batch": B,
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[:1],
        "kernel_ms": sum(c["ms"] for c in classes.values()),
        "bound_ms": sum(c["bound_ms"] for c in classes.values()),
        "classes": classes,
    }))


if __name__ == "__main__":
    main()
