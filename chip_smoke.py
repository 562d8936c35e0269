#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (airpose_tpu_torch).

  python3 chip_smoke.py        # from the repository root, on one CUDA device

Phases, each of which exits non-zero on failure:
  1. build every kernel under airpose_tpu_torch/csrc/ with nvcc for sm_90a;
  2. skinning kernel vs its plain version at the main path's shapes
     (B = 128 bodies, V = 10475, J = 55) and at the training batch B = 60,
     with its registers and occupancy, and timings beside two library
     yardsticks (lbs.py's einsum pair; cuBLAS's SGEMM of T's used rows);
  3. fused layer1 kernel vs its plain version at (128, 56, 56, 64) bf16,
     BN statistics perturbed from a seed, with timings;
  4. the bf16 perception chain at B = 64 frames (128 crops of 224²), full
     synthetic SMPL-X: both kernels must launch, outputs must be finite
     and agree with the same chain through the plain versions, then
     two_view_fps from CUDA events;
  5. the int8 conv kernel vs its plain version, exact, in every epilogue
     mode (the static trunk's requant at the next conv's scale, int8 alone
     and bf16 + int8, among them) at layer1's 3×3 (128, 56, 56, 64) and
     layer2_0's 3×3/2 (128, 56, 56, 128); then the 52 convs of the int8
     trunk at 128 crops, as the trunk makes them, replayed through the
     kernel, the plain version and torch._int_mm;
  6. the 13 int8 blocks of layers 2-4 chained at 128 crops of 224²: each
     within 1 int8 step on < 0.5% of elements of its plain version, with
     kernel, plain, torch._int_mm and bound times;
  7. the int8 chain and the int8-block chain at B = 64: the int8 conv
     kernel and skinning must launch, the int8 chain must quantize in torch
     once (the stem's output), outputs must be finite, each trunk's
     features must equal those of its plain version and each chain agree
     with its plain chain, the features must correlate > 0.9 with the bf16
     trunk's; then two_view_fps of each;
  8. the training step of record (make_twoview_step_fns, TrainConfig()
     defaults: AMSGrad at lr 5e-5, 3 IEF steps, dropout) on the bf16
     AirPoseTwoView at B = 30 frames of 224² from make_synthetic_dataset,
     full synthetic SMPL-X: the skinning Function's backward against
     autograd through the plain version at B = 60 bodies, with its times
     and bound; one step's loss and gradients with the skinning kernel
     against the same step with the plain version (same dropout masks),
     with an f32 and with the bf16 trunk, each beside the kernel step
     against itself; 25 steps on one batch, each launching skinning
     exactly once, with the loss finite and falling; one eval_step; then
     ms per step, frames/s, the forward / backward / optimizer split from
     CUDA events around loop.py's own spans and the device's idle share
     from torch.profiler;
  9. the other model families on the same B = 30 batch: twoview_eval_metrics
     of phase 8's eval_step predictions with the skinning kernel against the
     plain version; for hmr, copenet_singleview and muhmr
     (make_singleview_step_fns) and copenet_twoview_sep
     (make_twoview_step_fns), each with its bf16 trunk, one step with the
     kernel against one with the plain skinning, then 10 steps each
     launching skinning once with the loss finite and falling, and ms per
     step; the per-drone model behind Int8Inference (104 int8 conv launches,
     each trunk's features equal to its plain version's), and its staged
     serving (AirPoseTwoViewSepView.regress_step, 3 rounds a view) against
     its fused forward.
Prints the kernels as one JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is available.
"""

import contextlib
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): the bounds below.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12      # CUDA cores, no tensor cores
BF16_FLOP_PER_S = 989e12    # dense tensor cores
INT8_OP_PER_S = 1979e12     # dense tensor cores

SKIN_ATOL = 2e-5            # tests/test_pallas_lbs.py's bound for the TPU kernel
STAGE_TOL = 0.05            # atol = rtol, tests/test_fused_bottleneck.py's bound
# Kernel and plain chains differ only in f32 summation order inside layer1
# and skinning; that flips some bf16 roundings, which 13 random-weight bf16
# blocks and the IEF amplify. Bound on rel-L2 of verts and j2d between the
# two chains: on the CPU, changing only layer1's accumulation (f64 for f32)
# flipped 1.4% of its bf16 outputs by one ulp and moved verts by 0.9% and
# j2d by 0.16% rel-L2 at B = 2; the bound leaves 5× that.
CHAIN_REL_L2 = 5e-2
# The int8 trunks equal their plain versions bit for bit (the conv kernel is
# exact), so their chains differ only in skinning's f32 summation order:
# measured rel-L2 4.8e-8 (verts) and 4e-9 (j2d) on the H100.
INT8_CHAIN_REL_L2 = 1e-5
# int8 block outputs: the JAX package's bound for its Pallas block
# (tests/test_int8_bottleneck.py): ≤ 1 step on < 0.5% of elements.
BLOCK_MAX_STEP, BLOCK_FRAC = 1.0, 5e-3
FEATURE_CORR = 0.9          # int8 vs bf16 trunk features, tests/test_int8_trunk.py
# Skinning's backward against autograd through the plain version: both are
# f32 sums over V = 10475 (dA) or J = 55 (dp) in other orders; bound on the
# max |difference| over max |reference| of each gradient.
SKIN_GRAD_REL = 1e-5
# One train step with the skinning kernel against the same step with the
# plain version: the same weights, batch and dropout masks, so only
# skinning's f32 summation order differs (its backward's dA and dp are
# ~1e-7 relative apart). Measured on the H100 with either trunk: the loss
# equal, the regressor gradients 1.3e-9 rel-L2 apart; bounds 1e-6 (~10 f32
# ulps of the loss, ~1e3 times the measurement). The trunk's backward
# amplifies small differences: with an f32 trunk the step is not
# deterministic (its convolutions' backward, presumably) and its trunk
# gradients differ by up to 4.9e-5 rel-L2 from run to run, by up to 5.2e-5
# against the plain step; bound 1e-3, 20 times that floor, where a wrong
# gradient gives O(1).
# The bf16 step equals itself bit for bit, and its trunk gradients differ
# from the plain step's by 2.08e-2 in every call: skinning's ~1e-7
# differences flip roundings of the bf16 backward, each a 2^-8 relative
# step, which the trunk amplifies; bound 5e-2, 2.4 times the measurement.
TRAIN_F32_BOUNDS = {"loss": 1e-6, "regressor": 1e-6, "trunk": 1e-3}
TRAIN_BF16_BOUNDS = {"loss": 1e-6, "regressor": 1e-6, "trunk": 5e-2}
TRAIN_STEPS = 25
# Phase 9. Kernel step against plain step per family, on the bf16 trunk.
# Measured on the H100: each family's bf16 step equals itself bit for bit;
# against the plain step the loss is equal, the regressor gradients are
# 1.8e-9 (copenet_twoview_sep) to 6.0e-8 (hmr) rel-L2 apart, bound 1e-6 as
# in phase 8; the trunk gradients 1.78e-2 (hmr), 2.02e-2
# (copenet_singleview), 2.22e-2 (muhmr, copenet_twoview_sep) apart, as
# phase 8's bf16 step (flipped bf16 roundings in the trunk's backward);
# bound 5e-2, 2.25 times the largest.
FAMILY_BOUNDS = {family: {"loss": 1e-6, "regressor": 1e-6, "trunk": 5e-2}
                 for family in ("hmr", "copenet_singleview", "muhmr", "copenet_twoview_sep")}
FAMILY_STEPS = 10
# The six eval metrics with the kernel against the plain skinning: f32 sums
# in another order over 10,475 vertices, ~1e-7 relative.
EVAL_REL = 1e-5
# _sep int8 IEF on bit-equal features: only the f32 regressor's order.
INT8_SEP_REL_L2 = 1e-5
# staged _sep vs fused: the same trunks and cores on the same inputs.
STAGED_ATOL = 1e-5


def log(msg):
    print(msg, flush=True)


def wall_ms(fn, iters=20, warmup=3):
    """Time per call between two CUDA events: the device's time, waits for
    the host included."""
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


# ~0.1 s of spinning at the H100's 1.98 GHz: longer than the host takes to
# queue any timed run of kernels below
SLEEP_CYCLES = 200_000_000


def time_ms(fn, iters=20, warmup=3):
    """Device time per call: the timed calls are queued behind a spin kernel,
    so that the device runs them back to back whatever the host's speed (a
    kernel shorter than its host-side launch path would otherwise time the
    host)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def ptxas_lines(text, kernel):
    """ptxas -v's lines for one kernel: its spills, registers and static
    shared memory."""
    lines, out = text.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 6]:
                out.append(nxt.strip())
                if "registers" in nxt:
                    break
    return out


def skinning_at(w, a, p):
    """The skinning kernel against its plain version at one batch, then the
    kernel, the plain version, both library yardsticks and the bound."""
    from airpose_tpu_torch.bodymodel import cuda_lbs

    (B, J), V = a.shape[:2], w.shape[0]
    got = cuda_lbs.skinning(w, a, p)
    want = cuda_lbs.skinning_reference(w, a, p)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"skinning B={B}: max_abs_err {err:.3e} (atol {SKIN_ATOL})")
    check(err <= SKIN_ATOL, f"skinning kernel disagrees with its plain version at B={B}: {err}")

    def einsum_pair():  # the library yardstick: lbs.py's two einsums
        T = torch.einsum("vj,bjk->bvk", w, a.reshape(B, -1, 16)).reshape(B, -1, 4, 4)
        return torch.einsum("bvij,bvj->bvi", T[..., :3, :3], p) + T[..., :3, 3]

    # the floor of any library route: cuBLAS's f32 SGEMM of T's 12 used rows
    # (W @ A12, all the FMAs and nothing else; TF32 is off package-wide)
    a12 = a[:, :, :3, :].permute(1, 0, 2, 3).reshape(J, B * 12).contiguous()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the SGEMM yardstick")
    ms = time_ms(lambda: cuda_lbs.skinning(w, a, p), iters=50, warmup=5)
    paced_ms = wall_ms(lambda: cuda_lbs.skinning(w, a, p), iters=50, warmup=5)
    plain_ms = time_ms(lambda: cuda_lbs.skinning_reference(w, a, p))
    library_ms = time_ms(einsum_pair)
    sgemm_ms = time_ms(lambda: torch.mm(w, a12), iters=50, warmup=5)
    n_bytes = 4 * (w.numel() + a.numel() + p.numel() + got.numel())
    flops = B * V * (J * 12 * 2 + 18)
    bound_ms, bound_by = bound(n_bytes, flops, F32_FLOP_PER_S)
    log(f"skinning B={B}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
        f"{paced_ms:.4f} ms a call when the host paces the launches), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (einsum pair), "
        f"{sgemm_ms:.4f} ms (SGEMM W @ A12), bound {bound_ms:.4f} ms ({bound_by}), "
        f"kernel at {bound_ms / ms:.1%} of its bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "sgemm_ms": sgemm_ms,
            "host_paced_ms": paced_ms}


def phase_skinning(dev):
    """The main path's B = 128 bodies (two views of 64 frames), then the
    training slice's B = 60, at V = 10475, J = 55."""
    from airpose_tpu_torch.bodymodel import cuda_lbs, synthetic_smplx_params
    from airpose_tpu_torch.ops import _build

    B, V, J = 128, 10475, 55
    rng = np.random.default_rng(1)
    w = synthetic_smplx_params().lbs_weights.to(dev)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    a = torch.from_numpy(rel).to(dev)
    p = torch.from_numpy(rng.normal(size=(B, V, 3)).astype(np.float32)).to(dev)

    res = cuda_lbs.kernel_resources(J)
    ptxas = ptxas_lines(_build.build_log.get("lbs_skinning", ""), "skinning_kernel")
    log(f"skinning kernel: {res}; ptxas: {' | '.join(ptxas) or 'not built in this process'}")
    check(res["blocks_per_sm"] >= 1, f"a skinning block does not fit on an SM: {res}")
    row = skinning_at(w, a, p)
    row["at_b60"] = skinning_at(w, a[:60], p[:60])
    return {"name": "lbs_skinning", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/lbs_skinning.cu",
            "replaces": "airpose_tpu/bodymodel/pallas_lbs.py:75"} | row


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
    model, smplx_params, features = build_perception(dev, trunk="bf16")
    inputs = bench_inputs(B, dev)

    cuda_lbs.launches = fb.launches = 0
    verts, j2d = perceive(model, smplx_params, *inputs, features)
    torch.cuda.synchronize()
    launches = {"lbs_skinning": cuda_lbs.launches, "fused_stage1": fb.launches}
    log(f"chain: launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path did not launch: {launches}")
    check(tuple(verts.shape) == (B, 2, 10475, 3) and tuple(j2d.shape) == (B, 2, 127, 2),
          f"chain output shapes {tuple(verts.shape)}, {tuple(j2d.shape)}")
    check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()),
          "non-finite chain output")

    v_ref, j_ref = perceive(model, smplx_params, *inputs, features, use_kernels=False)
    rel = {k: ((a - b).norm() / b.norm()).item()
           for k, a, b in (("verts", verts, v_ref), ("j2d", j2d, j_ref))}
    log(f"chain vs plain chain: rel-L2 {rel} (bound {CHAIN_REL_L2})")
    check(all(r < CHAIN_REL_L2 for r in rel.values()), f"chain disagrees with the plain chain: {rel}")

    runs = two_view_fps(model, smplx_params, features, inputs)
    fps = float(np.median(runs))
    log(f"chain: two_view_fps median {fps:.1f} over {len(runs)} repeats "
        f"(min {min(runs):.1f}, max {max(runs):.1f}) at B={B}")
    return launches, fps


def int_mm_conv(x, w, m, b, ksize, stride=1, res=None, r=None, relu=False,
                out_dtype=torch.int8, qscale=None):
    """The library yardstick for one int8 conv (the port never calls it):
    im2col by torch indexing, torch._int_mm (cuBLASLt's s8 GEMM), then the
    kernel's epilogue in torch."""
    from airpose_tpu_torch.ops import int8_conv as ic

    N, H, W, _ = x.shape
    ho, wo = ic.out_size(H, ksize, stride), ic.out_size(W, ksize, stride)
    if ksize == 1:
        cols = x[:, ::stride, ::stride]
    else:
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, di:di + stride * (ho - 1) + 1:stride,
                             dj:dj + stride * (wo - 1) + 1:stride]
                          for di in range(3) for dj in range(3)], dim=-1)
    acc = torch._int_mm(cols.reshape(N * ho * wo, -1), w.t())
    return ic.epilogue(acc.view(N, ho, wo, -1), m, b, res, r, relu, out_dtype, qscale)


def max_diff(got, want):
    """max |got − want| over an output or a (bf16, int8) pair of outputs."""
    if isinstance(got, tuple):
        return max(max_diff(g, w) for g, w in zip(got, want))
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    return (got.float() - want.float()).abs().max().item()


def phase_int8_conv(dev, qparams, act_scales, crops):
    """The conv kernel exact against its plain version in every epilogue mode
    at two full-width shapes, then the int8 trunk's 52 convs at 128 crops
    replayed through the kernel, the plain version and torch._int_mm."""
    from airpose_tpu_torch.ops import int8_conv as ic
    from airpose_tpu_torch.ops import int8_trunk as it

    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16
    for name, (N, H, W, cin, cout, ksize, stride) in (
            ("layer1 3x3", (128, 56, 56, 64, 64, 3, 1)),
            ("layer2_0 3x3/2", (128, 56, 56, 128, 128, 3, 2))):
        K = ksize * ksize * cin
        x = torch.from_numpy(rng.integers(-127, 128, (N, H, W, cin), dtype=np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (cout, K), dtype=np.int8)).to(dev)
        m = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 20 / (np.sqrt(K) * 127 * 73)
                              ).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, 5, cout).astype(np.float32)).to(dev)
        shape = (N, ic.out_size(H, ksize, stride), ic.out_size(W, ksize, stride), cout)
        res_f = torch.from_numpy(rng.normal(0, 20, shape).astype(np.float32)).to(dev)
        # the requant scale 0.3 puts the largest values past the int8 clip
        modes = {"requant": dict(relu=True), "f32": dict(out_dtype=torch.float32),
                 "block_end": dict(res=(res_f.abs() % 128).to(torch.int8),
                                   r=torch.tensor(0.37, device=dev), relu=True),
                 "block_end_bf16": dict(res=res_f, relu=True, out_dtype=bf16),
                 "qconv": dict(res=res_f.to(bf16), relu=True, out_dtype=bf16),
                 "qconv_quant": dict(relu=True, out_dtype=torch.int8, qscale=0.3),
                 "qconv_dual": dict(res=res_f.to(bf16), relu=True, out_dtype=bf16,
                                    qscale=0.3)}
        for mode, kw in modes.items():
            got = ic.int8_conv(x, w, m, b, ksize, stride, **kw)
            want = ic.int8_conv_reference(x, w, m, b, ksize, stride, **kw)
            torch.cuda.synchronize()
            diff = max_diff(got, want)
            check(diff == 0.0, f"int8 conv {name} {mode}: kernel differs from its plain "
                  f"version by {diff}")
        q = want[1]
        check(bool((q.abs() == 127).any() and (q == 0).any()),
              f"int8 conv {name}: the requant modes clip nothing or relu nothing")
        for mode in ("qconv", "qconv_dual", "qconv_quant"):
            kw = modes[mode]
            ms = time_ms(lambda: ic.int8_conv(x, w, m, b, ksize, stride, **kw))
            plain_ms = time_ms(lambda: ic.int8_conv_reference(x, w, m, b, ksize, stride, **kw),
                               iters=3, warmup=1)
            library_ms = time_ms(lambda: int_mm_conv(x, w, m, b, ksize, stride, **kw))
            n_ops, n_bytes = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                                       kw.get("qscale"))
            bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OP_PER_S)
            log(f"int8_conv {name} {(N, H, W, cin)}→{cout} {mode}: kernel {ms:.4f} ms "
                f"({n_ops / ms / 1e9:.1f} TOPS), plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        log(f"int8_conv {name}: exact in {len(modes)} modes")

    # the trunk's 52 convs as the static trunk makes them (conv1/conv2 int8
    # out, conv3 bf16 + int8), captured from one int8 trunk run at 128 crops
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ic.int8_conv(*a, **kw)

    it.resnet50_int8_infer(qparams, crops, act_scales, conv=record)
    check(len(calls) == 52, f"the int8 trunk made {len(calls)} conv calls, expected 52")
    n_quant = sum(kw.get("qscale") is not None for _, kw in calls)
    check(n_quant == 47, f"{n_quant} of the trunk's convs requantize in their epilogue, "
          "expected 47 (all but the 4 projections and the last conv3)")
    err = 0.0
    for a, kw in calls:
        err = max(err, max_diff(ic.int8_conv(*a, **kw), ic.int8_conv_reference(*a, **kw)))
    torch.cuda.synchronize()
    log(f"int8_conv: the trunk's 52 convs ({n_quant} requantizing), max_abs_err {err} "
        "vs the plain version (exact)")
    check(err == 0.0, f"int8 conv kernel differs from its plain version in the trunk: {err}")

    def replay(fn):
        for a, kw in calls:
            fn(*a, **kw)

    ms = time_ms(lambda: replay(ic.int8_conv), iters=10)
    plain_ms = time_ms(lambda: replay(ic.int8_conv_reference), iters=2, warmup=1)
    library_ms = time_ms(lambda: replay(int_mm_conv), iters=10)
    n_ops = n_bytes = 0
    for (x, w, m, b, ksize, stride), kw in calls:
        o, nb = ic.conv_cost(x, w, ksize, stride, kw.get("res"), kw["out_dtype"],
                          kw.get("qscale"))
        n_ops, n_bytes = n_ops + o, n_bytes + nb
    bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OP_PER_S)
    log(f"int8_conv: 52 convs at 128 crops: {n_ops / 1e9:.1f} GOP, {n_bytes / 1e9:.3f} GB; "
        f"kernel {ms:.4f} ms ({n_ops / ms / 1e9:.1f} TOPS), plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "int8_conv", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/int8_conv.cu",
            "replaces": "airpose_tpu/ops/int8_trunk.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_int8_blocks(dev, model, blocks, crops):
    """The 13 int8 blocks of layers 2-4 chained at 128 crops: each against
    its plain version on the same input, then the chain's times."""
    from airpose_tpu_torch.ops import int8_bottleneck as ib

    with torch.no_grad():
        front = model.trunk(crops, part="front")
    h0 = torch.round(front.float() / blocks["s_in"]).clamp_(0, 127).to(torch.int8).contiguous()
    h, err, n_ops, n_bytes = h0, 0.0, 0, 0
    for i, blk in enumerate(blocks["blocks"]):
        got, want = ib.int8_block(h, blk), ib.int8_block_reference(h, blk)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        frac = (diff > 0).float().mean().item()
        err = max(err, diff.max().item())
        check(diff.max().item() <= BLOCK_MAX_STEP and frac < BLOCK_FRAC,
              f"int8 block {i}: max step {diff.max().item()} on {frac:.2e} of elements")
        B, H, W, cin = h.shape
        _, ho, wo, cout = got.shape
        cmid = blk["w1"].shape[0]
        # the TPU kernel's count: conv1 of a stride-2 block at the input resolution
        n_ops += 2 * B * (H * W * cin * cmid + ho * wo * (9 * cmid * cmid + cmid * cout
                                                          + (cin * cout if "wp" in blk else 0)))
        n_bytes += h.numel() + got.numel() * got.element_size() + sum(
            v.numel() * v.element_size() for v in blk.values() if torch.is_tensor(v))
        h = got
    check(h.dtype == torch.bfloat16 and tuple(h.shape) == (crops.shape[0], 7, 7, 2048),
          f"int8 blocks end in {h.dtype} {tuple(h.shape)}")
    log(f"int8_block: 13 blocks within {BLOCK_MAX_STEP} step on < {BLOCK_FRAC} of elements "
        f"(max |err| {err})")

    def chain(fn):
        x = h0
        for blk in blocks["blocks"]:
            x = fn(x, blk)
        return x

    ms = time_ms(lambda: chain(ib.int8_block), iters=10)
    plain_ms = time_ms(lambda: chain(ib.int8_block_reference), iters=2, warmup=1)
    library_ms = time_ms(lambda: chain(lambda x, blk: ib.run_block(int_mm_conv, x, blk)),
                         iters=10)
    bound_ms, bound_by = bound(n_bytes, n_ops, INT8_OP_PER_S)
    log(f"int8_block: 13 blocks at {crops.shape[0]} crops: {n_ops / 1e9:.1f} GOP, "
        f"{n_bytes / 1e9:.3f} GB; kernel {ms:.4f} ms ({n_ops / ms / 1e9:.1f} TOPS), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "int8_block", "route": "cuda",
            "source": "airpose_tpu_torch/csrc/int8_conv.cu",
            "replaces": "airpose_tpu/ops/int8_bottleneck.py:231",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_int8_chains(dev, model, smplx_params, chains, inputs, bf16_features):
    """The int8 chain and the int8-block chain at B = 64, each driven with
    the counters at 0, against its plain chain and the bf16 trunk.
    ``chains``: (name, features, int8 conv launches, int8_block calls,
    torch quantize calls of the int8 trunk)."""
    from airpose_tpu_torch.bench import two_view_fps
    from airpose_tpu_torch.bodymodel import cuda_lbs
    from airpose_tpu_torch.ops import int8_bottleneck as ib
    from airpose_tpu_torch.ops import int8_conv as ic
    from airpose_tpu_torch.ops import int8_trunk as it
    from airpose_tpu_torch.perception import perceive

    B = inputs[0].shape[0]
    crops = inputs[0].reshape((B * 2,) + inputs[0].shape[2:])
    with torch.no_grad():
        xf_bf16 = bf16_features(crops)
    launches, fps = {}, {}
    for name, features, n_conv, n_block, n_quant in chains:
        cuda_lbs.launches = ic.launches = ib.launches = it.quantize_calls = 0
        verts, j2d = perceive(model, smplx_params, *inputs, features)
        torch.cuda.synchronize()
        n = {"int8_conv": ic.launches, "int8_block calls": ib.launches,
             "lbs_skinning": cuda_lbs.launches, "torch quantize calls": it.quantize_calls}
        log(f"{name} chain: launches {n}")
        check(n == {"int8_conv": n_conv, "int8_block calls": n_block, "lbs_skinning": 1,
                    "torch quantize calls": n_quant},
              f"the {name} path launched {n}, expected {n_conv} int8 conv launches, "
              f"{n_block} int8_block calls, 1 skinning launch and {n_quant} torch "
              "quantize calls")
        launches[name] = n
        check(tuple(verts.shape) == (B, 2, 10475, 3) and tuple(j2d.shape) == (B, 2, 127, 2),
              f"{name} chain output shapes {tuple(verts.shape)}, {tuple(j2d.shape)}")
        check(bool(torch.isfinite(verts).all() and torch.isfinite(j2d).all()),
              f"non-finite {name} chain output")
        with torch.no_grad():
            xf = features(crops)
            xf_plain = features(crops, use_kernels=False)
        check(torch.equal(xf, xf_plain), f"{name} trunk differs from its plain version by "
              f"{(xf - xf_plain).abs().max().item()}")
        v_ref, j_ref = perceive(model, smplx_params, *inputs, features, use_kernels=False)
        rel = {k: ((a - b).norm() / b.norm()).item()
               for k, a, b in (("verts", verts, v_ref), ("j2d", j2d, j_ref))}
        log(f"{name} trunk equals its plain version; chain vs plain chain: rel-L2 {rel} "
            f"(bound {INT8_CHAIN_REL_L2})")
        check(all(r < INT8_CHAIN_REL_L2 for r in rel.values()),
              f"{name} chain disagrees with its plain chain: {rel}")
        corr = float(np.corrcoef(xf.cpu().numpy().ravel(), xf_bf16.cpu().numpy().ravel())[0, 1])
        feat_rel = ((xf - xf_bf16).norm() / xf_bf16.norm()).item()
        log(f"{name} trunk vs bf16 trunk: feature corr {corr:.6f}, rel-L2 {feat_rel:.4f} "
            f"(bound corr > {FEATURE_CORR})")
        check(corr > FEATURE_CORR, f"{name} features correlate {corr} with the bf16 trunk's")
        runs = two_view_fps(model, smplx_params, features, inputs)
        fps[name] = float(np.median(runs))
        log(f"{name} chain: two_view_fps median {fps[name]:.1f} over {len(runs)} repeats "
            f"(min {min(runs):.1f}, max {max(runs):.1f}) at B={B}")
    return launches, fps


def skinning_backward_at(w, a, p):
    """The skinning Function's gradients against autograd through the plain
    version at one batch, then the backward's times and bound."""
    from airpose_tpu_torch.bodymodel import cuda_lbs

    (B, J), V = a.shape[:2], w.shape[0]
    a, p = a.clone().requires_grad_(True), p.clone().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=tuple(p.shape)).astype(np.float32)
                         ).to(p.device)
    got = torch.autograd.grad(cuda_lbs.skinning(w, a, p), (a, p), g)
    ref_out = cuda_lbs.skinning_reference(w, a, p)
    want = torch.autograd.grad(ref_out, (a, p), g, retain_graph=True)
    torch.cuda.synchronize()
    rel = {k: ((x - y).abs().max() / y.abs().max()).item()
           for k, x, y in zip(("d_rel_tf", "d_v_posed"), got, want)}
    log(f"skinning backward B={B}: max relative error {rel} (bound {SKIN_GRAD_REL})")
    check(all(r <= SKIN_GRAD_REL for r in rel.values()),
          f"skinning backward disagrees with autograd through the plain version: {rel}")
    ad, pd = a.detach(), p.detach()
    ms = time_ms(lambda: cuda_lbs.skinning_backward(w, ad, pd, g), iters=50, warmup=5)
    paced_ms = wall_ms(lambda: cuda_lbs.skinning_backward(w, ad, pd, g), iters=50, warmup=5)
    plain_ms = time_ms(lambda: torch.autograd.grad(ref_out, (a, p), g, retain_graph=True))
    n_bytes = 4 * (w.numel() + 2 * a.numel() + 2 * p.numel() + g.numel())
    flops = 2 * V * J * B * 9 + 2 * B * V * 9 + B * V * 12 + 2 * J * V * B * 12
    bound_ms, bound_by = bound(n_bytes, flops, F32_FLOP_PER_S)
    log(f"skinning backward B={B}: {ms:.4f} ms (torch ops: two SGEMMs and elementwise "
        f"passes; {paced_ms:.4f} ms a call when the host paces the launches), autograd of "
        f"the einsum pair {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), at {bound_ms / ms:.1%} of its bound")
    return {"max_rel_err": max(rel.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "host_paced_ms": paced_ms}


class GradProbe:
    """A stand-in for the optimizer that keeps the gradients the train step
    hands it and updates nothing, so that steps driven through a step
    factory all start from the same weights."""

    def update(self, grads, opt_state, params):
        self.grads = grads


def grad_agreement(a, b):
    """Relative difference of two probed steps' losses and rel-L2 of their
    regressor's and trunk's gradients (core*, trunk*: one or one per drone);
    ``a``, ``b``: (loss, grads)."""
    (loss_a, ga), (loss_b, gb) = a, b

    def rel_l2(prefix):
        names = [n for n in gb if n.startswith(prefix)]
        num = sum((ga[n] - gb[n]).float().pow(2).sum() for n in names)
        return (num / sum(gb[n].float().pow(2).sum() for n in names)).sqrt().item()

    return {"loss": abs(loss_a - loss_b) / abs(loss_b),
            "regressor": rel_l2("core"), "trunk": rel_l2("trunk")}


def kernel_vs_plain_step(model, make_steps, cfg, batch, bounds, what):
    """One train step's loss and gradients with the skinning kernel against
    the same step with the plain version, each driven through the step
    factory (``make_steps(tx, use_kernels)`` → (train_step, eval_step))
    with GradProbe for its optimizer, from the same weights and generator
    seed (so the same dropout masks); the kernel step against itself gives
    the floor of the comparison."""
    from airpose_tpu_torch.train import create_train_state

    state, _ = create_train_state(model, cfg.lr)
    dev = batch["images"].device

    def probed_step(use_kernels):
        probe = GradProbe()
        step, _ = make_steps(probe, use_kernels)

        def run():
            _, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(11))
            return metrics["loss"].item(), probe.grads
        return run

    kernel_step = probed_step(True)
    first = kernel_step()
    floor = grad_agreement(kernel_step(), first)
    plain = grad_agreement(probed_step(False)(), first)
    log(f"train step, {what}: skinning kernel vs plain {plain} (bounds {bounds}); "
        f"kernel vs itself {floor}")
    check(all(plain[k] <= bounds[k] for k in bounds),
          f"the kernel's {what} train step disagrees with the plain step: {plain}")
    return {"vs_plain": plain, "vs_itself": floor}


def twoview_steps(model, smplx_params, cfg):
    """make_steps for the two-view models: the plain step skins through
    twoview_loss's plain version."""
    from airpose_tpu_torch.train import make_twoview_step_fns, twoview_loss

    def make_steps(tx, use_kernels):
        return make_twoview_step_fns(
            model, smplx_params, cfg, tx,
            loss=None if use_kernels else partial(twoview_loss, use_kernels=False))
    return make_steps


def singleview_steps(model, smplx_params, cfg, family):
    """make_steps for the single-view families and muhmr."""
    from airpose_tpu_torch.train import make_singleview_step_fns

    def make_steps(tx, use_kernels):
        return make_singleview_step_fns(model, smplx_params, cfg, tx, family,
                                        use_kernels=use_kernels)
    return make_steps


def phase_train(dev):
    """The two-view training step of record at B = 30 frames of 224²."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import airpose_tpu_torch.train.loop as loop
    from airpose_tpu_torch.bodymodel import cuda_lbs, synthetic_smplx_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns

    cfg = TrainConfig()
    B = cfg.batch_size
    smplx_params = synthetic_smplx_params().to(dev)
    batch = batch_slice(make_synthetic_dataset(smplx_params, B, seed=0), 0, B, dev)
    check(tuple(batch["images"].shape) == (B, 2, 224, 224, 3),
          f"synthetic batch images {tuple(batch['images'].shape)}")

    # skinning's backward at the step's 60 bodies, on the step's own inputs' scale
    rng = np.random.default_rng(3)
    rel = rng.normal(size=(2 * B, 55, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    backward = skinning_backward_at(
        smplx_params.lbs_weights, torch.from_numpy(rel).to(dev),
        torch.from_numpy(rng.normal(size=(2 * B, 10475, 3)).astype(np.float32)).to(dev))

    f32_model = AirPoseTwoView(seed=0).to(dev)
    agree = {"f32": kernel_vs_plain_step(f32_model, twoview_steps(f32_model, smplx_params, cfg),
                                         cfg, batch, TRAIN_F32_BOUNDS, "f32 trunk")}
    del f32_model
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=0).to(dev)
    agree["bf16"] = kernel_vs_plain_step(model, twoview_steps(model, smplx_params, cfg), cfg,
                                         batch, TRAIN_BF16_BOUNDS, "bf16 trunk")

    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_twoview_step_fns(model, smplx_params, cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    losses, launches = [], set()
    for i in range(TRAIN_STEPS):
        cuda_lbs.launches = 0
        state, metrics = train_step(state, batch, gen)
        losses.append(metrics["loss"].item())
        launches.add(cuda_lbs.launches)
        check(cuda_lbs.launches == 1,
              f"train step {i} launched skinning {cuda_lbs.launches} times, expected 1")
    log(f"train: {TRAIN_STEPS} steps at B={B}, losses {[round(x, 1) for x in losses]}")
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(np.mean(losses[-5:]) < np.mean(losses[:3]),
          f"training loss did not fall: first 3 {losses[:3]}, last 5 {losses[-5:]}")
    metrics, preds = eval_step(state, batch)
    check(tuple(preds["pred_rotmat"].shape) == (B, 2, 22, 3, 3)
          and bool(torch.isfinite(preds["pred_rotmat"]).all()),
          f"eval_step rotmats {tuple(preds['pred_rotmat'].shape)}")
    log(f"eval_step: loss {metrics['loss'].item():.1f}, pred_rotmat "
        f"{tuple(preds['pred_rotmat'].shape)}")

    # the step's time, then its parts: loop.py's record_function spans, each
    # also bracketed by two CUDA events (the name loop.py calls is replaced
    # here only)
    step_ms = wall_ms(lambda: train_step(state, batch, gen), iters=10, warmup=2)
    marks = []

    @contextlib.contextmanager
    def event_span(name):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with record_function(name):
            yield
        ev[1].record()
        marks.append((name, *ev))

    n_spans = 5
    with mock.patch.object(loop, "record_function", event_span):
        for _ in range(n_spans):
            train_step(state, batch, gen)
    torch.cuda.synchronize()
    spans = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for name, start, stop in marks:
        spans[name] += start.elapsed_time(stop) / n_spans
    # busy: the device time of every kernel and copy of 3 steps under the
    # profiler (the record_function spans' device-side ranges are not work);
    # idle share = 1 − busy / wall, wall from the unprofiled steps, as
    # profile_chain does (the profiler slows the host)
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = wall_ms(lambda: train_step(state, batch, gen), iters=n_prof, warmup=0)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.name not in spans]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / n_prof
    fps = B / (step_ms / 1e3)
    log(f"train step at B={B} frames (2·{B} crops of 224²): {step_ms:.3f} ms, {fps:.1f} "
        f"frames/s; spans (CUDA events) {{{', '.join(f'{k}: {v:.3f}' for k, v in spans.items())}}}"
        f" ms; device busy {busy_ms:.3f} ms a step in {len(device_events) / n_prof:.0f} "
        f"kernels and copies, idle share {1 - busy_ms / step_ms:.3f} (under the profiler: wall "
        f"{prof_ms:.3f} ms, idle share {1 - busy_ms / prof_ms:.3f})")
    by_name = {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n_prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("train step, top device time a step: " + "; ".join(f"{ms:.3f} ms {n[:90]}"
                                                            for n, ms in top))
    (backward["train_launches_per_step"],) = launches
    return backward, {"step_ms": step_ms, "frames_per_s": fps, "spans_ms": spans,
                      "busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
                      "profiled_step_ms": prof_ms,
                      "device_events_per_step": len(device_events) / n_prof,
                      "losses": losses, "kernel_vs_plain": agree}, (smplx_params, batch, preds)


def phase_eval_metrics(smplx_params, batch, preds):
    """Phase 9, check 3: twoview_eval_metrics of eval_step's predictions
    against the batch's GT, with the skinning kernel (two launches: the
    predicted and the GT bodies, 2·B each) and with the plain version."""
    from airpose_tpu_torch.bodymodel import cuda_lbs
    from airpose_tpu_torch.eval import twoview_eval_metrics

    args = (smplx_params, preds["pred_rotmat"], preds["pred_betas"], preds["pred_trans"],
            batch["gt_pose_rotmat"], batch["gt_orient"], batch["gt_betas"], batch["gt_trans"])
    cuda_lbs.launches = 0
    got = twoview_eval_metrics(*args)
    torch.cuda.synchronize()
    launches = cuda_lbs.launches
    check(launches == 2, f"twoview_eval_metrics launched skinning {launches} times, expected 2")
    want = twoview_eval_metrics(*args, use_kernels=False)
    got, want = ({k: v.item() for k, v in m.items()} for m in (got, want))
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    log(f"eval metrics after {TRAIN_STEPS} steps (B={batch['images'].shape[0]}): {got}; "
        f"kernel vs plain: max relative difference {rel:.3e} (bound {EVAL_REL})")
    check(len(got) == 6 and all(np.isfinite(v) for v in got.values()),
          f"eval metrics {got}")
    check(rel <= EVAL_REL, f"eval metrics with the kernel disagree with the plain ones: {rel}")
    return {"metrics": got, "plain": want, "max_rel": rel, "skinning_launches": launches}


def phase_families(dev, smplx_params, batch, steps=FAMILY_STEPS):
    """Phase 9, checks 1-2: each of the other families' train steps on the
    bf16 trunk (TrainConfig(model=family)), kernel step against plain step,
    then ``steps`` steps each launching skinning once (every family's loss
    makes one SMPL-X call: B bodies for hmr and copenet_singleview, 2·B
    folded for muhmr and the per-drone model), the loss falling."""
    from airpose_tpu_torch.bodymodel import cuda_lbs
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.models import MODEL_REGISTRY
    from airpose_tpu_torch.train import create_train_state

    B = batch["images"].shape[0]
    out = {}
    for family in FAMILY_BOUNDS:
        cfg = TrainConfig(model=family)
        model = MODEL_REGISTRY[family](dtype=torch.bfloat16, seed=0).to(dev)
        make_steps = (twoview_steps(model, smplx_params, cfg) if family == "copenet_twoview_sep"
                      else singleview_steps(model, smplx_params, cfg, family))
        agree = kernel_vs_plain_step(model, make_steps, cfg, batch, FAMILY_BOUNDS[family],
                                     f"{family}, bf16 trunk")
        state, tx = create_train_state(model, cfg.lr)
        train_step, _ = make_steps(tx, True)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        losses = []
        for i in range(steps):
            cuda_lbs.launches = 0
            state, metrics = train_step(state, batch, gen)
            losses.append(metrics["loss"].item())
            check(cuda_lbs.launches == 1, f"{family} train step {i} launched skinning "
                  f"{cuda_lbs.launches} times, expected 1")
        check(bool(np.isfinite(losses).all()), f"non-finite {family} training loss {losses}")
        check(np.mean(losses[-3:]) < np.mean(losses[:3]),
              f"{family} training loss did not fall: {losses}")
        step_ms = wall_ms(lambda: train_step(state, batch, gen), iters=5, warmup=1)
        log(f"{family}: {steps} steps at B={B}, losses {[round(x, 1) for x in losses]}; "
            f"{step_ms:.3f} ms a step, {B / step_ms * 1e3:.1f} frames/s")
        out[family] = {"kernel_vs_plain": agree, "losses": losses, "step_ms": step_ms,
                       "frames_per_s": B / step_ms * 1e3, "skinning_launches_per_step": 1}
        del model, state, tx, train_step, make_steps
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def phase_sep_serving(dev, batch):
    """Phase 9, checks 4-5: the per-drone model (bf16, seed 0) behind
    Int8Inference at B frames (each trunk quantized and calibrated on its
    own, on the first frame's two crops): 52 int8 conv launches and one
    torch quantize call per trunk, each trunk's features equal to its plain
    int8 conv version's, the IEF on them within INT8_SEP_REL_L2; then three
    staged rounds of AirPoseTwoViewSepView.regress_step for both views
    against the fused forward."""
    from airpose_tpu_torch import constants as C
    from airpose_tpu_torch.models import AirPoseTwoViewSep, AirPoseTwoViewSepView, mean_init_state
    from airpose_tpu_torch.ops import int8_conv as ic
    from airpose_tpu_torch.ops import int8_trunk as it

    images, bb = batch["images"], batch["bb"]
    B = images.shape[0]
    pos = torch.full_like(bb, 10.0 * C.TRANS_SCALE)
    model = AirPoseTwoViewSep(dtype=torch.bfloat16, seed=0).to(dev)
    shim = it.Int8Inference(model, images[0])
    ic.launches = it.quantize_calls = 0
    out = shim.apply(images, bb, pos)
    torch.cuda.synchronize()
    n = {"int8_conv": ic.launches, "torch quantize calls": it.quantize_calls}
    log(f"_sep int8 inference at B={B}: launches {n}")
    check(n == {"int8_conv": 104, "torch quantize calls": 2},
          f"_sep int8 inference launched {n}, expected 104 int8 conv launches and 2 torch "
          "quantize calls")
    check(bool(torch.isfinite(out.pose).all() and torch.isfinite(out.betas).all()),
          "non-finite _sep int8 output")
    xf = shim._features(images)
    plain = torch.stack([it.resnet50_int8_infer(shim.qparams[v], images[:, v],
                                                shim.act_scales[v], use_kernels=False)
                         for v in (0, 1)], dim=1)
    for v in (0, 1):
        check(torch.equal(xf[:, v], plain[:, v]), f"_sep int8 trunk{v} differs from its plain "
              f"version by {(xf[:, v] - plain[:, v]).abs().max().item()}")
    ref = model.from_features(plain, bb, pos)
    rel = {k: ((a - b).norm() / b.norm()).item()
           for k, a, b in (("pose", out.pose, ref.pose), ("betas", out.betas, ref.betas))}
    log(f"_sep int8: each trunk's features equal their plain version's; IEF vs plain: "
        f"rel-L2 {rel} (bound {INT8_SEP_REL_L2})")
    check(all(r <= INT8_SEP_REL_L2 for r in rel.values()),
          f"_sep int8 IEF disagrees with the plain one: {rel}")
    ms = wall_ms(lambda: shim.apply(images, bb, pos), iters=10, warmup=2)
    log(f"_sep int8 inference: {ms:.3f} ms a call, {B / ms * 1e3:.1f} two-view frames/s")

    fused = model(images, bb, pos)
    views = []
    for v in (0, 1):
        view = AirPoseTwoViewSepView(dtype=torch.bfloat16, seed=1, view=v)
        view.load_state_dict(model.state_dict())
        views.append(view.to(dev))
    feats = [views[v](images[:, v]) for v in (0, 1)]
    theta, shape = mean_init_state((B, 2), dev)[:2]
    pose = torch.cat([pos, theta], dim=-1)
    for _ in range(3):
        steps = [views[v].regress_step(feats[v], bb[:, v], pose[:, v], shape[:, v],
                                       pose[:, 1 - v, 9:], shape[:, 1 - v]) for v in (0, 1)]
        pose = torch.stack([p for p, _ in steps], dim=1)
        shape = torch.stack([s for _, s in steps], dim=1)
    diff = max((pose - fused.pose).abs().max().item(), (shape - fused.betas).abs().max().item())
    log(f"staged _sep (3 rounds of regress_step per view) vs fused: max |diff| {diff:.3e} "
        f"(bound {STAGED_ATOL})")
    check(diff <= STAGED_ATOL, f"staged _sep serving disagrees with the fused forward: {diff}")
    return {"int8": {"launches": n, "ief_rel_l2": rel, "ms": ms, "frames_per_s": B / ms * 1e3},
            "staged_max_abs_diff": diff}


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

    from airpose_tpu_torch.ops.int8_bottleneck import (quantize_trunk_blocks,
                                                       resnet50_int8_block_infer)
    from airpose_tpu_torch.perception import bench_inputs, build_perception, chain_ops

    model, smplx_params, int8_features = build_perception(dev, trunk="int8")
    qparams, act_scales = int8_features.args[0], int8_features.keywords["act_scales"]
    blocks = quantize_trunk_blocks(qparams, act_scales)
    block_features = partial(resnet50_int8_block_infer, model.trunk, blocks)
    inputs = bench_inputs(64, dev)
    crops = inputs[0].reshape((128,) + inputs[0].shape[2:])
    kernels.append(phase_int8_conv(dev, qparams, act_scales, crops))
    kernels.append(phase_int8_blocks(dev, model, blocks, crops))
    int8_launches, int8_fps = phase_int8_chains(
        dev, model, smplx_params,
        (("int8", int8_features, 52, 0, 1), ("int8_block", block_features, 42, 13, 0)),
        inputs, chain_ops(model, "bf16"))
    log(f"two_view_fps: bf16 {fps:.1f}, int8 {int8_fps['int8']:.1f}, "
        f"int8_block {int8_fps['int8_block']:.1f}")
    del model, smplx_params, int8_features, qparams, blocks, block_features, inputs, crops
    torch.cuda.empty_cache()
    kernels[0]["backward"], train, (smplx_params, batch, preds) = phase_train(dev)
    log(json.dumps({"train_step": train}))
    t9 = time.perf_counter()
    families = {"eval_metrics": phase_eval_metrics(smplx_params, batch, preds)}
    families["train_steps"] = phase_families(dev, smplx_params, batch)
    families["sep_serving"] = phase_sep_serving(dev, batch)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    log(json.dumps({"families": families}))
    # launches: kernel launches in the main path's run of the chain that uses
    # each kernel (int8_block: its 42 conv launches, beside its 13 block calls)
    launches["int8_conv"] = int8_launches["int8"]["int8_conv"]
    launches["int8_block"] = int8_launches["int8_block"]["int8_conv"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "int8_block":
            k["blocks"] = int8_launches["int8_block"]["int8_block calls"]
    # launches on phase 9's paths: skinning once a train step of each family
    # and twice in the eval metrics, the int8 conv in the _sep int8 inference
    kernels[0]["phase9_launches"] = {
        **{f"{f} train step": v["skinning_launches_per_step"]
           for f, v in families["train_steps"].items()},
        "twoview_eval_metrics": families["eval_metrics"]["skinning_launches"]}
    next(k for k in kernels if k["name"] == "int8_conv")["phase9_launches"] = {
        "_sep int8 inference": families["sep_serving"]["int8"]["launches"]["int8_conv"]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    log(f"card after the run: {' / '.join(clocks.splitlines())}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
