"""int8 ResNet bottleneck blocks of layers 2-4: ``int8_block`` on the int8
conv kernel (csrc/int8_conv.cu) and its plain PyTorch version.

Counterpart of airpose_tpu/ops/int8_bottleneck.py. One block, with static
activation scales (s_in of the block input, s_y1, s_y2 of the conv inputs,
s_out of the next block's input) folded into per-channel multipliers:

  1. y1 = clip(rint(relu(acc1·m1 + b1)), 0, 127)       conv1 1×1
  2. y2 = clip(rint(relu(acc2·m2 + b2)), 0, 127)       conv2 3×3, stride 1 or 2
  3. y3 = acc3·m3 + b3                                   conv3 1×1, s_out units
  4. res = x·r (identity) or accp·mp + bp (stride-2 1×1 projection, f32)
  5. out = relu(y3 + res) → int8 clip(rint(·), 0, 127), or bf16 for the last block

On CUDA an identity block is 3 launches of the conv kernel (requant,
requant, block end with the int8 residual) and a projection block 4 (the
projection to f32 comes third). conv1 of a stride-2 block runs at the input
resolution, as the TPU kernel's does on its four phase planes; the 3×3
stride-2 taps are read directly.

Block operands (``quantize_trunk_blocks``): w1 (Cmid, Cin), w2
(Cmid, 9·Cmid), w3 (Cout, Cmid), wp (Cout, Cin) int8 in the kernel's
(Cout, K) layout; m*, b* (C,) f32; r a 1-element f32 tensor; ``stride``
and ``out_int8`` as plain values.
"""

from typing import Dict, List

import torch

from ..utils.profiling import span
from . import _build
from .int8_conv import int8_conv_cuda, int8_conv_reference

launches = 0  # int8_block calls that launched their kernels, since the last reset

_NAMES = [(stage, blk) for stage, blocks in ((2, 4), (3, 6), (4, 3)) for blk in range(blocks)]


def quantize_trunk_blocks(qparams: Dict, act_scales: Dict) -> Dict:
    """The block operands of layers 2-4 from ``int8_trunk.quantize_trunk_params``
    output and a calibrated ``act_scales`` table: the port of
    airpose_tpu/ops/int8_bottleneck.py::quantize_trunk_pallas, with m and b
    formed in f32 in its order, (s_in·ws)/s_out and b/s_out.

    → {"s_in": scale of the front output, "blocks": [13 operand dicts]}."""
    blocks: List[Dict] = []
    for idx, (stage, blk) in enumerate(_NAMES):
        bname = f"layer{stage}_{blk}"
        q = qparams[bname]
        s_in = float(act_scales[f"{bname}/conv1"])
        s_y1 = float(act_scales[f"{bname}/conv2"])
        s_y2 = float(act_scales[f"{bname}/conv3"])
        last = idx + 1 == len(_NAMES)
        s_out = 1.0 if last else float(act_scales["layer{}_{}/conv1".format(*_NAMES[idx + 1])])
        out = {"stride": 2 if blk == 0 else 1, "out_int8": not last}
        for i, (conv, s, s_next) in enumerate(
                (("conv1", s_in, s_y1), ("conv2", s_y1, s_y2), ("conv3", s_y2, s_out)), 1):
            out[f"w{i}"] = q[conv]["wq"]
            out[f"m{i}"] = s * q[conv]["ws"] / s_next
            out[f"b{i}"] = q[conv]["b"] / s_next
        if blk == 0:
            out["wp"] = q["proj"]["wq"]
            out["mp"] = s_in * q["proj"]["ws"] / s_out
            out["bp"] = q["proj"]["b"] / s_out
        else:
            out["r"] = torch.tensor(s_in / s_out, dtype=torch.float32,
                                    device=q["conv1"]["b"].device)
        blocks.append(out)
    return {"s_in": float(act_scales["layer2_0/conv1"]), "blocks": blocks}


def run_block(conv, x: torch.Tensor, blk: Dict) -> torch.Tensor:
    """One block through ``conv``, any function with the signature of
    ``int8_conv.int8_conv``: 3 calls for an identity block, 4 for a
    projection block."""
    stride = blk["stride"]
    out_dtype = torch.int8 if blk["out_int8"] else torch.bfloat16
    y1 = conv(x, blk["w1"], blk["m1"], blk["b1"], 1, 1, relu=True)
    y2 = conv(y1, blk["w2"], blk["m2"], blk["b2"], 3, stride, relu=True)
    if "wp" in blk:
        res = conv(x, blk["wp"], blk["mp"], blk["bp"], 1, stride, out_dtype=torch.float32)
        return conv(y2, blk["w3"], blk["m3"], blk["b3"], 1, 1, res=res, relu=True,
                    out_dtype=out_dtype)
    return conv(y2, blk["w3"], blk["m3"], blk["b3"], 1, 1, res=x, r=blk["r"], relu=True,
                out_dtype=out_dtype)


def int8_block_reference(x: torch.Tensor, blk: Dict) -> torch.Tensor:
    """Plain version: the lax transcription of tests/test_int8_bottleneck.py
    in torch, every conv exact (ops/int8_conv.int8_conv_reference).
    (B, H, W, Cin) int8 → (B, h, w, Cout) int8, or bf16 for the last block."""
    return run_block(int8_conv_reference, x, blk)


def int8_block(x: torch.Tensor, blk: Dict) -> torch.Tensor:
    """One quantized bottleneck block: the kernel on CUDA tensors, the plain
    version on CPU tensors. At stride 2 H and W must be even, as the JAX
    block's phase split requires."""
    global launches
    if blk["stride"] == 2 and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"int8_block: a stride-2 block takes even H and W, got "
                         f"{tuple(x.shape[1:3])}")
    if x.device.type == "cpu":
        return int8_block_reference(x, blk)
    out = run_block(int8_conv_cuda, x, blk)
    if out.numel():
        with _build.count_lock:
            launches += 1
    return out


def resnet50_int8_block_infer(trunk, blocks: Dict, x: torch.Tensor,
                              use_kernels: bool = True) -> torch.Tensor:
    """(N, H, W, 3) f32 → (N, 2048) f32 GAP feature: the trunk's own bf16
    stem and layer1 (``trunk(x, part="front")``, BatchNorm as in the flax
    trunk), then the 13 int8 blocks of layers 2-4 (``blocks`` from
    ``quantize_trunk_blocks``). The port of
    airpose_tpu/ops/int8_bottleneck.py::resnet50_int8_pallas_infer."""
    with span("front"):
        front = trunk(x, part="front")
    with span("int8_layers"):
        # post-relu, so the clip's lower bound is 0
        h = torch.round(front.float() / blocks["s_in"]).clamp_(0, 127).to(torch.int8)
        h = h.contiguous()
        block = int8_block if use_kernels else int8_block_reference
        for blk in blocks["blocks"]:
            h = block(h, blk)
        return h.float().mean(dim=(1, 2))
