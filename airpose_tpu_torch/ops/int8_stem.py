"""The int8 trunk's stem: the CUDA kernel ``csrc/int8_stem.cu`` and its plain
PyTorch version.

The stem takes (N, H, W, 3) f32 crops, the folded-BN stem weight w
(64, 3, 7, 7) bf16 and bias b (64,) f32 to the (N, Hp, Wp, 64) bf16 map the
int8 layers read (ops/int8_trunk.py's ``int8_stem``;
airpose_tpu/ops/int8_trunk.py:175-184 on the TPU):

    y = relu(bf16(f32(maxpool_3x3/2,pad 1(bf16(conv_7x7/2,pad 3(bf16(x), w)))) + b))

with Ho = (H − 1) // 2 + 1 and Hp = (Ho − 1) // 2 + 1 (224 → 112 → 56). The
pool comes first: relu(bf16(f32(h) + b)) is monotone in h, so it commutes
with the max, and the bias and relu touch a quarter of the values.

The kernel does all of it in one launch, the convolution on the tensor cores
(wgmma) with one tile shape and one order of summation at every batch size,
so a crop's output is the same bits alone and at any place in any batch
(cuDNN's bf16 convolution, which the plain version calls on a card, picks
its order by batch size). Its sums are not the plain version's, so the two
lie one bf16 step of the map apart on a few elements.

``stem`` takes the plain version only for CPU tensors, where it is the
port's path (bit-equal to the JAX package's); on CUDA tensors it launches
the kernel or raises.
"""

import torch
from torch.nn import functional as F

from . import _build

launches = 0  # kernel launches since the last reset (a plain integer)

BF16 = torch.bfloat16


def out_size(n: int) -> int:
    """Output rows (or columns) of ``n`` input rows: 7×7, stride 2, pad 3;
    also the 3×3, stride 2, pad 1 pool's."""
    return (n - 1) // 2 + 1


def stem_cost(x: torch.Tensor):
    """(operations, bytes) of one call: 2·147 per output of the 64-channel
    conv map; the f32 crops read once, the bf16 weights and the f32 bias
    read once, the pooled bf16 map written once (no halo, no K padding)."""
    N, H, W, _ = x.shape
    conv_out = N * out_size(H) * out_size(W) * 64
    pooled = N * out_size(out_size(H)) * out_size(out_size(W)) * 64
    return 2 * 147 * conv_out, x.numel() * 4 + 64 * 147 * 2 + 64 * 4 + pooled * 2


def stem_conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain conv: torch's bf16 convolution of the crops rounded to bf16
    (cuDNN on a card; its order of summation depends on the batch size there)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(BF16), w, stride=2, padding=3)
    return y.permute(0, 2, 3, 1)


def stem_conv_ordered(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv map summed tap by tap in the order (c, kh, kw) in f32 from
    +0, each product of two bf16 values exact in f32, then rounded to bf16
    once: the same on any device and at any batch size; memory-hungry (an f32
    map and one tap's patch at a time)."""
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
    """(N, H, W, 3) CPU crops → the (N, Ho, Wo, 64) bf16 conv map, before
    the pool (the plain conv). On a card the kernel never writes this map:
    ``stem`` is the whole stem."""
    if x.device.type != "cpu":
        raise ValueError(f"stem_conv: x is on {x.device}; on a card the stem is one "
                         f"kernel (stem), which writes no conv map")
    return stem_conv_reference(x, w)


def pool(h: torch.Tensor) -> torch.Tensor:
    """The 3×3/2 max-pool (−inf padding) of an (N, Ho, Wo, 64) map."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def pool_bias_relu(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem after its conv, on an (N, Ho, Wo, 64) bf16 map: the pool,
    then + b in f32 rounded to bf16 once and the relu, in place on the
    pooled map."""
    return pool(h).add_(b).relu_()


def one_step_range(pooled: torch.Tensor, b: torch.Tensor):
    """(lo, hi): the stem outputs that the pre-bias pooled map ``pooled``
    gives when each of its values moves by up to one bf16 step (|v|·2^-7,
    + 1e-6 where a sum cancels towards 0), through the monotone bias and
    relu. A stem whose conv sums in another order than the one ``pooled``
    came from, and so flips some roundings of the map by one step, lies in
    it: a flipped map value moves the output by one step of the map, not of
    the output."""
    p = pooled.float()
    s = p.abs() * 2.0 ** -7 + 1e-6
    return ((p - s) + b).to(BF16).relu_(), ((p + s) + b).to(BF16).relu_()


def stem_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the plain conv, then the pool, the bias and the relu."""
    return pool_bias_relu(stem_conv_reference(x, w), b)


def stem_ordered(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same with the conv summed in one fixed order (stem_conv_ordered)."""
    return pool_bias_relu(stem_conv_ordered(x, w), b)


def stem(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) crops → (N, Hp, Wp, 64) bf16: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    fn = stem_reference if x.device.type == "cpu" else stem_cuda
    return fn(x, w, b)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel's copies
    move 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stem_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"stem_cuda: x is on {x.device}, not CUDA")
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem_cuda: x has shape {tuple(x.shape)}, expected (N, H, W, 3)")
    if w.device != x.device or w.dtype != BF16 or tuple(w.shape) != (64, 3, 7, 7):
        raise ValueError(f"stem_cuda: w is {w.dtype} {tuple(w.shape)} on {w.device}, "
                         f"expected bfloat16 (64, 3, 7, 7) on {x.device}")
    if b.device != x.device or b.dtype != torch.float32 or tuple(b.shape) != (64,):
        raise ValueError(f"stem_cuda: b is {b.dtype} {tuple(b.shape)} on {b.device}, "
                         f"expected float32 (64,) on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        raise RuntimeError("stem_cuda has no backward")
    # the kernel reads f32 and rounds to bf16 itself; bf16 → f32 is exact
    x, w, b = _aligned(x.float()), _aligned(w), b.contiguous()
    N, H, W, _ = x.shape
    out = torch.empty((N, out_size(out_size(H)), out_size(out_size(W)), 64), dtype=BF16,
                      device=x.device)
    if out.numel():
        fn = _build.function("int8_stem", "airpose_int8_stem", 4, 3)
        dev = x.device.index
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, W,
                     torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "int8_stem")
        with _build.count_lock:
            launches += 1
    return out
