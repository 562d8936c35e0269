#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (airpose_tpu_torch).

  python3 chip_smoke.py        # from the repository root, on one CUDA device

Phases, each of which exits non-zero on failure:
  1. build every kernel under airpose_tpu_torch/csrc/ with nvcc for sm_90a;
  2. skinning kernel vs its plain version at the main path's shapes
     (B = 128 bodies, V = 10475, J = 55), with timings;
  3. fused layer1 kernel vs its plain version at (128, 56, 56, 64) bf16,
     BN statistics perturbed from a seed, with timings;
  4. the perception chain at B = 64 frames (128 crops of 224²), full
     synthetic SMPL-X: both kernels must launch, outputs must be finite
     and agree with the same chain through the plain versions, then
     two_view_fps from CUDA events.
Prints the kernels as one JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is available.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): the bounds below.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12      # CUDA cores, no tensor cores
BF16_FLOP_PER_S = 989e12    # dense tensor cores

SKIN_ATOL = 2e-5            # tests/test_pallas_lbs.py's bound for the TPU kernel
STAGE_TOL = 0.05            # atol = rtol, tests/test_fused_bottleneck.py's bound
# Kernel and plain chains differ only in f32 summation order inside layer1
# and skinning; that flips some bf16 roundings, which 13 random-weight bf16
# blocks and the IEF amplify. Bound on rel-L2 of verts and j2d between the
# two chains: on the CPU, changing only layer1's accumulation (f64 for f32)
# flipped 1.4% of its bf16 outputs by one ulp and moved verts by 0.9% and
# j2d by 0.16% rel-L2 at B = 2; the bound leaves 5× that.
CHAIN_REL_L2 = 5e-2


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n_bytes, flops, flop_rate):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase_skinning(dev):
    from airpose_tpu_torch.bodymodel import cuda_lbs, synthetic_smplx_params

    B, V, J = 128, 10475, 55
    rng = np.random.default_rng(1)
    w = synthetic_smplx_params().lbs_weights.to(dev)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    a = torch.from_numpy(rel).to(dev)
    p = torch.from_numpy(rng.normal(size=(B, V, 3)).astype(np.float32)).to(dev)

    got = cuda_lbs.skinning(w, a, p)
    want = cuda_lbs.skinning_reference(w, a, p)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"skinning: max_abs_err {err:.3e} (atol {SKIN_ATOL})")
    check(err <= SKIN_ATOL, f"skinning kernel disagrees with its plain version: {err}")

    ms = time_ms(lambda: cuda_lbs.skinning(w, a, p))
    plain_ms = time_ms(lambda: cuda_lbs.skinning_reference(w, a, p))

    def einsum_pair():  # the library yardstick: lbs.py's two einsums
        T = torch.einsum("vj,bjk->bvk", w, a.reshape(B, -1, 16)).reshape(B, -1, 4, 4)
        return torch.einsum("bvij,bvj->bvi", T[..., :3, :3], p) + T[..., :3, 3]

    library_ms = time_ms(einsum_pair)
    n_bytes = 4 * (w.numel() + a.numel() + p.numel() + got.numel())
    flops = B * V * (J * 12 * 2 + 18)
    bound_ms, bound_by = bound(n_bytes, flops, F32_FLOP_PER_S)
    log(f"skinning: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "lbs_skinning", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/lbs_skinning.cu",
            "replaces": "airpose_tpu/bodymodel/pallas_lbs.py:75",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_stage1(dev):
    import torch.nn.functional as F

    from airpose_tpu_torch.models.resnet import ResNet50
    from airpose_tpu_torch.ops import fused_bottleneck as fb

    B, h, w = 128, 56, 56
    rng = np.random.default_rng(2)
    trunk = ResNet50(generator=torch.Generator().manual_seed(2))
    sd = trunk.state_dict()
    for k in sd:  # perturb layer1's BN statistics so that folding is non-trivial
        if k.startswith("layer1.") and k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.startswith("layer1.") and k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    ops = [{k: v.to(dev) for k, v in blk.items()}
           for blk in fb.stage1_params_from_state_dict(sd)]
    # a post-relu, post-maxpool stem output is non-negative
    x = torch.from_numpy(np.abs(rng.normal(size=(B, h, w, 64))).astype(np.float32)
                         ).to(dev, torch.bfloat16)

    got = fb.fused_stage1(x, ops)
    want = fb.fused_stage1_reference(x, ops)
    torch.cuda.synchronize()
    gf, wf = got.float(), want.float()
    err = (gf - wf).abs().max().item()
    close = torch.allclose(gf, wf, atol=STAGE_TOL, rtol=STAGE_TOL)
    log(f"fused_stage1: max_abs_err {err:.3e}, mean |out| {wf.abs().mean().item():.3e}, "
        f"allclose(atol=rtol={STAGE_TOL}) {close}")
    check(close, "fused layer1 kernel disagrees with its plain version")
    check(wf.abs().mean().item() > 1e-3, "fused layer1 output is trivially zero")

    # the library yardstick: the same folded blocks as cuDNN bf16 convolutions
    lib = []
    for blk in ops:
        conv = {k: blk[k].reshape(blk[k].shape[0], -1, 1, 1) for k in ("w1", "w3", "wp") if k in blk}
        conv["w2"] = blk["w2"].reshape(64, 3, 3, 64).permute(0, 3, 1, 2)
        lib.append({k: v.contiguous(memory_format=torch.channels_last) for k, v in conv.items()}
                   | {k: blk[k].to(torch.bfloat16) for k in ("b1", "b2", "b3", "bp") if k in blk})
    xc = x.permute(0, 3, 1, 2)

    def cudnn_chain():
        a = xc
        for blk in lib:
            y = F.relu(F.conv2d(a, blk["w1"], blk["b1"]))
            y = F.relu(F.conv2d(y, blk["w2"], blk["b2"], padding=1))
            y = F.conv2d(y, blk["w3"], blk["b3"])
            a = F.relu(y + (F.conv2d(a, blk["wp"], blk["bp"]) if "wp" in blk else a))
        return a

    ms = time_ms(lambda: fb.fused_stage1(x, ops))
    plain_ms = time_ms(lambda: fb.fused_stage1_reference(x, ops), iters=5, warmup=1)
    library_ms = time_ms(cudnn_chain)
    hw = h * w
    flops = B * 2 * hw * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256
                          + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
    n_bytes = (x.numel() + got.numel()) * 2 + sum(
        t.numel() * t.element_size() for blk in ops for t in blk.values())
    bound_ms, bound_by = bound(n_bytes, flops, BF16_FLOP_PER_S)
    log(f"fused_stage1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {"name": "fused_stage1", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/fused_stage1.cu",
            "replaces": "airpose_tpu/ops/fused_bottleneck.py:176",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_chain(dev):
    from airpose_tpu_torch.bench import two_view_fps
    from airpose_tpu_torch.bodymodel import cuda_lbs
    from airpose_tpu_torch.ops import fused_bottleneck as fb
    from airpose_tpu_torch.perception import bench_inputs, build_perception, perceive

    B = 64
    model, smplx_params, stage_ops = build_perception(dev)
    inputs = bench_inputs(B, dev)

    cuda_lbs.launches = fb.launches = 0
    verts, j2d = perceive(model, smplx_params, *inputs, stage_ops=stage_ops)
    torch.cuda.synchronize()
    launches = {"lbs_skinning": cuda_lbs.launches, "fused_stage1": fb.launches}
    log(f"chain: launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path did not launch: {launches}")
    check(tuple(verts.shape) == (B, 2, 10475, 3) and tuple(j2d.shape) == (B, 2, 127, 2),
          f"chain output shapes {tuple(verts.shape)}, {tuple(j2d.shape)}")
    check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()),
          "non-finite chain output")

    v_ref, j_ref = perceive(model, smplx_params, *inputs, stage_ops=stage_ops,
                            use_kernels=False)
    rel = {k: ((a - b).norm() / b.norm()).item()
           for k, a, b in (("verts", verts, v_ref), ("j2d", j2d, j_ref))}
    log(f"chain vs plain chain: rel-L2 {rel} (bound {CHAIN_REL_L2})")
    check(all(r < CHAIN_REL_L2 for r in rel.values()), f"chain disagrees with the plain chain: {rel}")

    runs = two_view_fps(model, smplx_params, stage_ops, inputs)
    fps = float(np.median(runs))
    log(f"chain: two_view_fps median {fps:.1f} over {len(runs)} repeats "
        f"(min {min(runs):.1f}, max {max(runs):.1f}) at B={B}")
    return launches, fps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import airpose_tpu_torch  # noqa: F401  (turns TF32 off)
    from airpose_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"build: {seconds:.1f} s")
    for name, text in sorted(_build.build_log.items()):
        log(f"--- nvcc {name}.cu\n{text.strip()}")

    kernels = [phase_skinning(dev), phase_stage1(dev)]
    launches, fps = phase_chain(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
