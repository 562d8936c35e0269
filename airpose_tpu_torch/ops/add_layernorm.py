"""Residual add, LayerNorm and cast in one pass: the CUDA kernel
``csrc/add_layernorm.cu`` and its plain PyTorch version.

The ViT (models/vit.py: HMR 2.0's ViT-H/16, Multi-HMR's DINOv2 ViT-L/14)
keeps a float32 residual stream ``x`` of (..., C) and, at each of its
2·depth + 1 norm points, adds the branch that is still pending, scaled by
its LayerScale ``gamma`` where the backbone has one (DINOv2), and
normalises the result into the next layer's input:

    x += branch          or   x += gamma * branch    (in place; none at block 0's norm1)
    y = LayerNorm(x; weight, bias, eps).to(out_dtype)

``out_dtype`` is the backbone's compute dtype for the blocks' norms and
float32 for ``last_norm``. The plain version is exactly those PyTorch ops.
The kernel makes the same float32 product and add (the product rounded,
then the sum), so ``x`` comes out bit-equal, and
sums the LayerNorm's statistics in another order, which moves a rare bf16
output by one step.

``add_layernorm`` takes the plain version only for CPU tensors; on CUDA
tensors it launches the kernel or raises. The kernel has no backward: it
raises where autograd would need one.
"""

from typing import Optional

import torch
from torch.nn import functional as F

from . import _build

BRANCH_KINDS = {None: 0, torch.bfloat16: 1, torch.float32: 2}
OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}
MAX_WIDTH = 1536  # 32 lanes × 4 values × the kernel's K_MAX chunks


def add_layernorm_cost(x: torch.Tensor, branch: Optional[torch.Tensor],
                       out_dtype: torch.dtype) -> int:
    """Bytes one call must move: x read, the branch read and x written (when
    there is a branch), y written."""
    n = x.numel()
    branch_bytes = 0 if branch is None else n * (branch.element_size() + 4)
    return n * 4 + branch_bytes + n * out_dtype.itemsize


def add_layernorm_reference(x: torch.Tensor, branch: Optional[torch.Tensor],
                            weight: torch.Tensor, bias: torch.Tensor, eps: float,
                            out_dtype: torch.dtype,
                            gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x += branch``, or ``x += gamma * branch`` with a ``gamma`` (nothing
    where ``branch`` is None), then the LayerNorm of ``x`` over its last
    axis in float32, cast to ``out_dtype``."""
    if branch is not None:
        x += branch if gamma is None else gamma * branch
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps).to(out_dtype)


def add_layernorm(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: torch.Tensor, eps: float, out_dtype: torch.dtype,
                  gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` updated in place by ``branch`` (scaled by ``gamma`` where one
    is given), and its LayerNorm in ``out_dtype``: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return add_layernorm_reference(x, branch, weight, bias, eps, out_dtype, gamma)
    return add_layernorm_cuda(x, branch, weight, bias, eps, out_dtype, gamma)


def add_layernorm_cuda(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                       bias: torch.Tensor, eps: float, out_dtype: torch.dtype,
                       gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take."""
    C = x.shape[-1]
    if C % 8 or not 0 < C <= MAX_WIDTH:
        raise ValueError(f"add_layernorm: width {C}, the kernel takes multiples of 8 up to "
                         f"{MAX_WIDTH}")
    if out_dtype not in OUT_KINDS:
        raise ValueError(f"add_layernorm: output dtype {out_dtype}, the kernel writes "
                         "bfloat16 or float32")
    if branch is not None and branch.dtype not in BRANCH_KINDS:
        raise ValueError(f"add_layernorm: branch is {branch.dtype}, the kernel reads "
                         "bfloat16 or float32")
    if x.device.type != "cuda":
        raise ValueError(f"add_layernorm: x is on {x.device}, not CUDA")
    inputs = (("x", x, torch.float32, x.shape), ("weight", weight, torch.float32, (C,)),
              ("bias", bias, torch.float32, (C,)))
    if branch is None:
        gamma = None
    else:
        inputs += (("branch", branch, branch.dtype, x.shape),)
    if gamma is not None:
        inputs += (("gamma", gamma, torch.float32, (C,)),)
    for name, t, dtype, shape in inputs:
        _build.check_tensor("add_layernorm", name, t, x.device, dtype, shape, 16)
    if torch.is_grad_enabled() and any(t.requires_grad for _, t, _, _ in inputs):
        raise RuntimeError("add_layernorm: the kernel has no backward (run it under no_grad)")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // C
    if rows:
        fn = _build.function("add_layernorm", "airpose_add_layernorm", 6, 4, 1)
        args = (x.data_ptr(), None if branch is None else branch.data_ptr(),
                None if gamma is None else gamma.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), y.data_ptr(), rows, C,
                BRANCH_KINDS[None if branch is None else branch.dtype], OUT_KINDS[out_dtype],
                eps)
        _build.launch(fn, args, x.device, "add_layernorm")
    return y
