"""The int8 trunk's stem convolution: the CUDA kernel ``csrc/int8_stem.cu``
and its plain PyTorch version.

It computes the 7×7, stride 2, pad 3 convolution of (N, H, W, 3) crops,
rounded to bf16, with the folded-BN stem weight (64, 3, 7, 7) bf16 into the
(N, Ho, Wo, 64) bf16 map the stem's max-pool reads (ops/int8_trunk.py's
``int8_stem``; airpose_tpu/ops/int8_trunk.py:175-180 on the TPU). The kernel
sums each output's 147 products in one fixed order (c, kh, kw) in f32 and
rounds once, so a crop's map is the same bits at every batch size; cuDNN's
bf16 convolution, which the plain version calls on a card, picks its
summation order by batch size.

``stem_conv`` takes the plain version only for CPU tensors, where it is the
port's path (bit-equal to the JAX package's); on CUDA tensors it launches
the kernel or raises.
"""

import torch
from torch.nn import functional as F

from . import _build

launches = 0  # kernel launches since the last reset (a plain integer)

BF16 = torch.bfloat16


def out_size(n: int) -> int:
    """Output rows (or columns) of ``n`` input rows: 7×7, stride 2, pad 3."""
    return (n - 1) // 2 + 1


def stem_cost(x: torch.Tensor):
    """(operations, bytes) of one call: 2·147 per output of the 64-channel
    map; the f32 crops read once, the bf16 weights read once, the bf16 map
    written once."""
    N, H, W, _ = x.shape
    outputs = N * out_size(H) * out_size(W) * 64
    return 2 * 147 * outputs, x.numel() * 4 + 64 * 147 * 2 + outputs * 2


def stem_conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: torch's bf16 convolution of the crops rounded to bf16
    (cuDNN on a card; its order of summation depends on the batch size there)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(BF16), w, stride=2, padding=3)
    return y.permute(0, 2, 3, 1)


def stem_conv_ordered(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: each output summed tap by tap
    in the order (c, kh, kw) in f32 from +0, each product of two bf16 values
    exact in f32, then rounded to bf16 once. Bit-equal to the kernel on any
    device; memory-hungry (an f32 map and one tap's patch at a time)."""
    N, H, W, _ = x.shape
    ho, wo = out_size(H), out_size(W)
    xp = F.pad(x.to(BF16).float(), (0, 0, 3, 3, 3, 3))
    wf = w.float()
    acc = torch.zeros(N, ho, wo, 64, dtype=torch.float32, device=x.device)
    for c in range(3):
        for kh in range(7):
            for kw in range(7):
                patch = xp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2, c]
                acc.add_(patch[..., None] * wf[:, c, kh, kw])
    return acc.to(BF16)


def stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) crops → (N, Ho, Wo, 64) bf16: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    fn = stem_conv_reference if x.device.type == "cpu" else stem_conv_cuda
    return fn(x, w)


def stem_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_cuda: x is on {x.device}, not CUDA")
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem_conv_cuda: x has shape {tuple(x.shape)}, expected (N, H, W, 3)")
    if w.device != x.device or w.dtype != BF16 or tuple(w.shape) != (64, 3, 7, 7):
        raise ValueError(f"stem_conv_cuda: w is {w.dtype} {tuple(w.shape)} on {w.device}, "
                         f"expected bfloat16 (64, 3, 7, 7) on {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"stem_conv_cuda: {x.shape[0]} crops; the grid takes at most 65,535")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("stem_conv_cuda has no backward")
    # the kernel reads f32 and rounds to bf16 itself; bf16 → f32 is exact
    x = x.float().contiguous()
    w = w.contiguous()
    N, H, W, _ = x.shape
    out = torch.empty((N, out_size(H), out_size(W), 64), dtype=BF16, device=x.device)
    if out.numel():
        fn = _build.function("int8_stem", "airpose_int8_stem", 3, 3)
        dev = x.device.index
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W,
                     torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "int8_stem")
        with _build.count_lock:
            launches += 1
    return out
