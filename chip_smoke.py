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
     trunk's; then two_view_fps of each.
Prints the kernels as one JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is available.
"""

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
    plain_ms = time_ms(lambda: cuda_lbs.skinning_reference(w, a, p))
    library_ms = time_ms(einsum_pair)
    sgemm_ms = time_ms(lambda: torch.mm(w, a12), iters=50, warmup=5)
    n_bytes = 4 * (w.numel() + a.numel() + p.numel() + got.numel())
    flops = B * V * (J * 12 * 2 + 18)
    bound_ms, bound_by = bound(n_bytes, flops, F32_FLOP_PER_S)
    log(f"skinning B={B}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (einsum pair), "
        f"{sgemm_ms:.4f} ms (SGEMM W @ A12), bound {bound_ms:.4f} ms ({bound_by}), "
        f"kernel at {bound_ms / ms:.1%} of its bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "sgemm_ms": sgemm_ms}


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
    # launches: kernel launches in the main path's run of the chain that uses
    # each kernel (int8_block: its 42 conv launches, beside its 13 block calls)
    launches["int8_conv"] = int8_launches["int8"]["int8_conv"]
    launches["int8_block"] = int8_launches["int8_block"]["int8_conv"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "int8_block":
            k["blocks"] = int8_launches["int8_block"]["int8_block calls"]
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
