"""int8 convolution with a fused epilogue: the CUDA kernel
``csrc/int8_conv.cu`` and its plain PyTorch version.

One kernel family serves both int8 trunks of the port. It is the port of
airpose_tpu/ops/int8_bottleneck.py::int8_block (ops/int8_bottleneck.py
runs a block as 3 or 4 launches) and it computes each conv of
airpose_tpu/ops/int8_trunk.py::_qconv (ops/int8_trunk.py).

Layouts: x (N, H, W, Cin) int8 NHWC; w (Cout, kh·kw·Cin) int8 with
k = (kh·KW + kw)·Cin + cin; m, b (Cout,) f32. 1×1 and 3×3 kernels pad
``ksize // 2`` on each side, also at stride 2. The epilogue, in f32:

  v = f32(acc)·m + b
  res int8 (with r):  v = v + f32(res)·r       identity shortcut of a block
  res f32:            v = v + res              projection shortcut of a block
  res bf16:           v = f32(bf16(v)) + f32(res)   conv3 of the _qconv trunk
  relu (optional), then int8 clip(round(v), −127, 127) (half to even),
  f32, or bf16.

With ``qscale`` s (the next conv's static activation scale) the epilogue
also quantizes its bf16 result, exactly as ops/int8_trunk.py's
``_quantize_act`` does: q = int8 clip(round(f32(bf16(v)) / s), −127, 127),
an IEEE f32 division. ``out_dtype`` int8 then returns q alone (the bf16 map
is never written); bf16 returns the pair (bf16 map, q).

``int8_conv`` takes the plain version only for CPU tensors; on CUDA
tensors it launches the kernel or raises.
"""

from typing import Optional

import torch
from torch.nn import functional as F

from . import _build

launches = 0  # kernel launches since the last reset (a plain integer)

_RES_KIND = {None: 0, torch.int8: 1, torch.float32: 2, torch.bfloat16: 3}
_OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_QUANT = {torch.int8: 3, torch.bfloat16: 4}  # with qscale: int8 alone, or bf16 + int8


def out_size(n: int, ksize: int, stride: int) -> int:
    """Output rows (or columns) of ``n`` input rows, padding ``ksize // 2``."""
    return (n + 2 * (ksize // 2) - ksize) // stride + 1


def conv_cost(x: torch.Tensor, w: torch.Tensor, ksize: int, stride: int,
              res: Optional[torch.Tensor], out_dtype: torch.dtype,
              qscale: Optional[float] = None):
    """(operations, bytes) one conv of ``int8_conv`` must do and move: each
    input read once (x, w, m, b, the residual), each output written once
    (with ``qscale``: the int8 map, and beside it the bf16 map where
    ``out_dtype`` is bf16)."""
    N, H, W, _ = x.shape
    cout, K = w.shape
    M = N * out_size(H, ksize, stride) * out_size(W, ksize, stride)
    n_bytes = (x.numel() + w.numel() + 8 * cout
               + (0 if res is None else res.numel() * res.element_size())
               + M * cout * torch.empty((), dtype=out_dtype).element_size()
               + (M * cout if qscale is not None and out_dtype != torch.int8 else 0))
    return 2 * M * K * cout, n_bytes


def quantize(x: torch.Tensor, s) -> torch.Tensor:
    """int8 clip(round(x / s), −127, 127) of f32 ``x``, half to even, with
    an IEEE f32 division by ``s`` (a float or a 0-dim f32 tensor) on every
    device: torch divides a CUDA tensor by a Python scalar as a multiply by
    its reciprocal, which can round differently."""
    if not torch.is_tensor(s):
        s = torch.full((), s, dtype=torch.float32, device=x.device)
    return torch.round(x / s).clamp_(-127, 127).to(torch.int8)


def epilogue(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
             res: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
             relu: bool = False, out_dtype: torch.dtype = torch.int8,
             qscale: Optional[float] = None):
    """The kernel's epilogue on an int32 accumulator (..., Cout), in torch."""
    v = acc.float() * m + b
    if res is not None:
        if res.dtype == torch.bfloat16:
            v = v.to(torch.bfloat16).float() + res.float()
        elif res.dtype == torch.int8:
            v = v + res.float() * r
        else:
            v = v + res
    if relu:
        v = torch.relu(v)
    if qscale is not None:
        h = v.to(torch.bfloat16)
        q = quantize(h.float(), qscale)
        return q if out_dtype == torch.int8 else (h, q)
    if out_dtype == torch.int8:
        return torch.round(v).clamp_(-127, 127).to(torch.int8)
    return v.to(out_dtype)


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                        b: torch.Tensor, ksize: int, stride: int = 1,
                        res: Optional[torch.Tensor] = None,
                        r: Optional[torch.Tensor] = None, relu: bool = False,
                        out_dtype: torch.dtype = torch.int8,
                        qscale: Optional[float] = None):
    """Plain version: an f64 convolution of the int8 values, exact because
    |acc| ≤ 9·2048·127² < 2^53 (f32 would round sums past 2^24), cast to
    int32, then ``epilogue``. Outputs are NHWC-contiguous, as the kernel's
    are, whatever the layout of ``x``: a later reduction over them then
    sums in the same order on both paths."""
    cout, cin = w.shape[0], x.shape[-1]
    wk = w.reshape(cout, ksize, ksize, cin).permute(0, 3, 1, 2).double()
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), wk, stride=stride,
                   padding=ksize // 2)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32, memory_format=torch.contiguous_format)
    return epilogue(acc, m, b, res, r, relu, out_dtype, qscale)


def int8_conv(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
              ksize: int, stride: int = 1, res: Optional[torch.Tensor] = None,
              r: Optional[torch.Tensor] = None, relu: bool = False,
              out_dtype: torch.dtype = torch.int8, qscale: Optional[float] = None):
    """(N, H, W, Cin) int8 → (N, Ho, Wo, Cout) ``out_dtype`` (with
    ``qscale``: see the module's docstring): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    fn = int8_conv_reference if x.device.type == "cpu" else int8_conv_cuda
    return fn(x, w, m, b, ksize, stride, res, r, relu, out_dtype, qscale)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"int8_conv_cuda: {name} is on {t.device}, not {device}")
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"int8_conv_cuda: {name} is {t.dtype} {tuple(t.shape)}, "
                         f"expected {dtype} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"int8_conv_cuda: {name} is not contiguous")


def int8_conv_cuda(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                   b: torch.Tensor, ksize: int, stride: int = 1,
                   res: Optional[torch.Tensor] = None,
                   r: Optional[torch.Tensor] = None, relu: bool = False,
                   out_dtype: torch.dtype = torch.int8, qscale: Optional[float] = None):
    """Launch the kernel once; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv_cuda: x is on {x.device}, not CUDA")
    if x.ndim != 4:
        raise ValueError(f"int8_conv_cuda: x has shape {tuple(x.shape)}, "
                         "expected (N, H, W, Cin)")
    N, H, W, cin = x.shape
    cout = w.shape[0]
    if ksize not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"int8_conv_cuda: {ksize}×{ksize} stride {stride}; the "
                         "kernel takes 1×1 and 3×3 at stride 1 or 2")
    if cin % 32:
        raise ValueError(f"int8_conv_cuda: Cin {cin} is not a multiple of 32")
    if cout % 8:
        raise ValueError(f"int8_conv_cuda: Cout {cout} is not a multiple of 8")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"int8_conv_cuda: output dtype {out_dtype}, expected "
                         "int8, float32 or bfloat16")
    if qscale is not None:
        if out_dtype not in _OUT_QUANT:
            raise ValueError("int8_conv_cuda: qscale quantizes a bf16 result into "
                             f"int8 or bf16 + int8, not {out_dtype}")
        qscale = float(qscale)
        if not 0.0 < qscale < float("inf"):
            raise ValueError(f"int8_conv_cuda: qscale {qscale} is not a positive scale")
    ho, wo = out_size(H, ksize, stride), out_size(W, ksize, stride)
    _check("x", x, x.device, torch.int8, (N, H, W, cin))
    _check("w", w, x.device, torch.int8, (cout, ksize * ksize * cin))
    _check("m", m, x.device, torch.float32, (cout,))
    _check("b", b, x.device, torch.float32, (cout,))
    if res is not None:
        if res.dtype not in _RES_KIND:
            raise ValueError(f"int8_conv_cuda: residual dtype {res.dtype}, expected "
                             "int8, float32 or bfloat16")
        _check("res", res, x.device, res.dtype, (N, ho, wo, cout))
        if res.dtype == torch.int8:
            if r is None:
                raise ValueError("int8_conv_cuda: an int8 residual needs its scale r")
            _check("r", r.reshape(1), x.device, torch.float32, (1,))
    # x, w and the residual are copied in chunks of up to 16 bytes; m and b
    # are read as pairs of neighbouring channels
    for name, t, align in (("x", x, 16), ("w", w, 16), ("res", res, 16), ("m", m, 8),
                           ("b", b, 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"int8_conv_cuda: {name} is not {align}-byte aligned")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (m, b, res)):
        raise RuntimeError("int8_conv_cuda has no backward")
    out = torch.empty((N, ho, wo, cout), dtype=out_dtype, device=x.device)
    dual = qscale is not None and out_dtype == torch.bfloat16
    out_q = torch.empty_like(out, dtype=torch.int8) if dual else None
    if out.numel():
        fn = _build.function("int8_conv", "airpose_int8_conv", 8, 10, 1)
        rs = r if res is not None and res.dtype == torch.int8 else None
        kind = _OUT_KIND[out_dtype] if qscale is None else _OUT_QUANT[out_dtype]
        args = (x.data_ptr(), w.data_ptr(), m.data_ptr(), b.data_ptr(),
                None if res is None else res.data_ptr(),
                None if rs is None else rs.data_ptr(), out.data_ptr(),
                None if out_q is None else out_q.data_ptr(),
                N, H, W, cin, cout, ksize, stride, int(relu),
                _RES_KIND[None if res is None else res.dtype], kind,
                0.0 if qscale is None else qscale)
        # The trunk makes 52 of these calls per step and its later layers wait
        # on the host, so the launch skips the device guard and the Stream
        # object where it can.
        dev = x.device.index
        if dev == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        _build.check(err, "int8_conv")
        with _build.count_lock:
            launches += 1
    return (out, out_q) if dual else out
