"""Quantization-aware training (port of airpose_tpu/ops/qat.py): straight-
through fake-quant of the trunk's conv kernels and, optionally, of their
input activations.

    q(W) = clip(round(W / s), ±L) · s,   s = max|W[c]| / L per output channel
    the forward sees q(W); the backward sees the identity (W + (q(W) − W).detach())

The per-output-channel axis is the JAX kernel's last (HWIO) axis, which is
torch's first (OIHW) axis. The stem conv is excluded, as deployment keeps it
bf16 (ops/int8_trunk.py).
"""

from typing import Dict, Mapping

import torch

from .. import device_constant

TRUNK_KEYS = ("trunk", "trunk0", "trunk1")


def fake_quant_weight(k: torch.Tensor, levels: float = 127.0) -> torch.Tensor:
    """Symmetric per-output-channel fake quantization of an OIHW kernel with
    a straight-through gradient; ``levels`` 127 is the int8 grid."""
    amax = k.detach().abs().reshape(k.shape[0], -1).amax(dim=1)
    scale = torch.clamp(amax / levels, min=1e-12).reshape((-1,) + (1,) * (k.ndim - 1))
    q = torch.clamp(torch.round(k.detach() / scale), -levels, levels) * scale
    return k + (q - k.detach())


def fake_quant_act(x: torch.Tensor, levels: float = 127.0, scale=None) -> torch.Tensor:
    """Per-tensor symmetric STE fake-quant of an activation: the dynamic
    abs-max scale with ``scale=None`` (no gradient through it), else the
    frozen calibrated step, clipping included. Quantizes in f32 and keeps
    the input dtype."""
    xf = x.float()
    if scale is None:
        s = torch.clamp(xf.detach().abs().amax() / levels, min=1e-12)
    else:
        if not torch.is_tensor(scale):
            scale = device_constant(float(scale), torch.float32, x.device)
        s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32, device=x.device),
                        min=1e-12)
    q = torch.clamp(torch.round(xf.detach() / s), -levels, levels) * s
    return (xf + (q - xf.detach())).to(x.dtype)


def _is_trunk_conv(name: str) -> bool:
    """Whether a parameter name (``trunk.layer1.0.conv1.weight``) is a
    residual-stage conv kernel of a trunk: the tensors deployment quantizes."""
    keys = name.split(".")
    return (len(keys) >= 5 and keys[0] in TRUNK_KEYS and keys[1].startswith("layer")
            and (keys[3].startswith("conv") or keys[3:5] == ["downsample", "0"])
            and keys[-1] == "weight")


def fake_quant_trunk_params(params: Mapping[str, torch.Tensor],
                            levels: float = 127.0) -> Dict[str, torch.Tensor]:
    """``params`` (named parameters of a model) with STE fake-quant applied
    to every residual-stage conv kernel of its trunk(s); heads, BatchNorm
    and the stem pass through."""
    return {n: fake_quant_weight(p, levels) if _is_trunk_conv(n) else p
            for n, p in params.items()}
