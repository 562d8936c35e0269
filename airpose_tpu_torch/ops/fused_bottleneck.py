"""Fused ResNet-50 layer1 stage: the CUDA kernel ``csrc/fused_stage1.cu`` and
its plain PyTorch version.

Counterpart of airpose_tpu/ops/fused_bottleneck.py (``fused_stage1``). In
eval mode, with BatchNorm folded into the convolutions, layer1 runs as
three bottleneck blocks (block 0 64 → 256 with a projection shortcut,
blocks 1-2 with identity shortcuts) over (B, 56, 56, 64) bf16 NHWC. The
kernel keeps y1 and y2 on chip and launches once per block, a persistent
grid whose blocks hold the block's weights in shared memory and walk over
bands of image rows; the source explains the tiling and what bounds it on
an H100. ``fused_stage1`` takes
the plain version only for CPU tensors; on CUDA tensors it launches the
kernel or raises.

Stage operands (``stage1_params_from_state_dict``) are a list of three
dicts, one per block, in the kernel's layout: 1×1 weights (Cout, Cin) and
the 3×3 weight (Cout, 9·Cin) with k = (kh·3 + kw)·Cin + cin, all bf16;
biases (Cout,) f32; block 0 adds ``wp``/``bp``.
"""

from typing import Dict, List, Mapping

import torch
from torch.nn import functional as F

from ..utils.profiling import span
from . import _build

C_IN = 64           # layer1 input channels (after stem+maxpool)
C_MID = 64
C_OUT = 256
MAX_WIDTH = 128     # beside the resident weights, shared memory holds bands of at most this width

StageOps = List[Dict[str, torch.Tensor]]


def fold_bn_into_conv(weight, bn_weight, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Inference-time BN folding for an OIHW conv: conv→BN ≡ conv with
    W' = W·γ/√(σ²+ε) per output channel and bias b' = β − μ·γ/√(σ²+ε)."""
    s = bn_weight.float() / torch.sqrt(bn_var.float() + eps)
    return (weight.float() * s.reshape(-1, 1, 1, 1),
            bn_bias.float() - bn_mean.float() * s)


def fuse_stage_params(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """One bottleneck block's state-dict entries (``prefix`` + 'conv1.weight',
    'bn1.running_mean', ...) → folded f32 weights in the kernel's layout."""
    def fold(conv, bn):
        return fold_bn_into_conv(
            sd[f"{prefix}{conv}.weight"], sd[f"{prefix}{bn}.weight"],
            sd[f"{prefix}{bn}.bias"], sd[f"{prefix}{bn}.running_mean"],
            sd[f"{prefix}{bn}.running_var"])

    out = {}
    for i in (1, 2, 3):
        w, b = fold(f"conv{i}", f"bn{i}")
        out[f"w{i}"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # (O, kh·kw·I)
        out[f"b{i}"] = b
    if f"{prefix}downsample.0.weight" in sd:
        w, b = fold("downsample.0", "downsample.1")
        out["wp"] = w.reshape(w.shape[0], -1)
        out["bp"] = b
    return out


def stage1_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                                  prefix: str = "") -> StageOps:
    """Fold the trunk's layer1 blocks (keys ``{prefix}layer1.{b}.…``, e.g. a
    ``ResNet50.state_dict()``) into the kernel's operands: bf16 weights,
    f32 biases, on the state dict's device."""
    return [
        {k: (v.to(torch.bfloat16) if v.ndim > 1 else v.float()).contiguous()
         for k, v in fuse_stage_params(sd, f"{prefix}layer1.{b}.").items()}
        for b in range(3)
    ]


def fused_stage1_reference(x: torch.Tensor, stage_ops: StageOps) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points: bf16 operands,
    f32 accumulation (f32 products of bf16 values), f32 biases, relu and
    bf16 rounding after y1, after y2 and after each block; each 3×3 conv
    as one 576-deep im2col matmul. (B, h, w, 64) bf16 → (B, h, w, 256) bf16."""
    B, h, w, _ = x.shape
    acts = x.to(torch.bfloat16)
    for blk in stage_ops:
        a = acts.float()
        y1 = F.relu(a @ blk["w1"].float().T + blk["b1"]).to(torch.bfloat16)
        pad = F.pad(y1, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([pad[:, di:di + h, dj:dj + w]
                          for di in range(3) for dj in range(3)], dim=-1)
        y2 = F.relu(cols.float() @ blk["w2"].float().T + blk["b2"]).to(torch.bfloat16)
        y3 = y2.float() @ blk["w3"].float().T + blk["b3"]
        res = a @ blk["wp"].float().T + blk["bp"] if "wp" in blk else a
        acts = F.relu(y3 + res).to(torch.bfloat16)
    return acts


def fused_stage1(x: torch.Tensor, stage_ops: StageOps) -> torch.Tensor:
    """layer1 over (B, h, w, 64) bf16 NHWC → (B, h, w, 256) bf16: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_stage1_reference(x, stage_ops)
    return fused_stage1_cuda(x, stage_ops)


def fused_stage1_cuda(x: torch.Tensor, stage_ops: StageOps) -> torch.Tensor:
    """Launch the kernel once per block; raises on anything it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage1_cuda: x is on {x.device}, not CUDA")
    if x.ndim != 4:
        raise ValueError(f"fused_stage1_cuda: x has shape {tuple(x.shape)}, "
                         "expected (B, h, w, 64)")
    B, h, w, _ = x.shape
    if not 0 < w <= MAX_WIDTH:
        raise ValueError(f"fused_stage1_cuda: width {w}, the kernel takes 1..{MAX_WIDTH}")
    if len(stage_ops) != 3:
        raise ValueError("fused_stage1_cuda: expected the operands of 3 blocks")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_stage1_cuda has no backward")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_tensor("fused_stage1_cuda", "x", x, x.device, bf16, (B, h, w, C_IN))
    for i, blk in enumerate(stage_ops):
        cin = C_IN if i == 0 else C_OUT
        specs = {"w1": (bf16, (C_MID, cin)), "b1": (f32, (C_MID,)),
                 "w2": (bf16, (C_MID, 9 * C_MID)), "b2": (f32, (C_MID,)),
                 "w3": (bf16, (C_OUT, C_MID)), "b3": (f32, (C_OUT,))}
        if i == 0:
            specs.update(wp=(bf16, (C_OUT, C_IN)), bp=(f32, (C_OUT,)))
        elif "wp" in blk:
            raise ValueError(f"fused_stage1_cuda: block {i} has a projection")
        for k, (dt, shape) in specs.items():
            if k not in blk:
                raise ValueError(f"fused_stage1_cuda: block {i} lacks {k}")
            _build.check_tensor("fused_stage1_cuda", f"block {i} {k}", blk[k], x.device, dt,
                                shape)
    fn = _build.function("fused_stage1", "airpose_bottleneck_block", 10, 4)
    acts = x
    for i, blk in enumerate(stage_ops):
        out = torch.empty((B, h, w, C_OUT), dtype=bf16, device=x.device)
        if B and h:
            ptr = [blk[k].data_ptr() for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
            wp, bp = (blk["wp"].data_ptr(), blk["bp"].data_ptr()) if i == 0 else (None, None)
            _build.launch(fn, (acts.data_ptr(), *ptr, wp, bp, out.data_ptr(), B, h, w,
                               C_IN if i == 0 else C_OUT), x.device, "fused_stage1")
        acts = out
    return acts


def resnet50_fused_infer(trunk, x: torch.Tensor, stage_ops: StageOps = None,
                         use_kernels: bool = True) -> torch.Tensor:
    """Inference-only trunk forward (N, H, W, 3) → (N, 2048): the trunk's
    own stem and layers 2-4 (cuDNN convolutions) around the fused layer1
    stage. ``stage_ops`` defaults to folding the trunk's own layer1; with
    ``use_kernels=False`` layer1 runs its plain version on any device."""
    if stage_ops is None:
        stage_ops = stage1_params_from_state_dict(trunk.state_dict())
    with span("stem"):
        stem = trunk(x, part="stem").to(torch.bfloat16).contiguous()
    with span("layer1"):
        h = (fused_stage1 if use_kernels else fused_stage1_reference)(stem, stage_ops)
    with span("tail"):
        return trunk(h, part="tail")
