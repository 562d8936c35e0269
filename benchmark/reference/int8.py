"""Plain int8 post-training-quantized ResNet-50 trunk, from the float state
dict.

  * BatchNorm is folded into each conv: W' = W·γ/√(σ² + ε), b' = β − μ·γ/√(σ² + ε).
  * Weights: symmetric per output channel, scale max|W'|/L, round half to
    even, clip ±L (L = 127 for int8; the control runs L = 7, int4).
  * Activations: symmetric per tensor, the input of every residual-stage
    conv, q = clip(round(x / s), ±L) with an IEEE float32 division. The
    scales are calibrated by one forward over sample crops in which every
    conv input takes its own scale max|x|/L.
  * Each conv sums its integer products exactly (in float64), then
    v = f32(acc)·(xs·ws) + b in float32; conv3 adds the block's bf16 shortcut
    to its bf16-rounded v; relu; the result is rounded to bf16, which the
    next conv quantizes.
  * The stem stays a folded bf16 conv (float32 sums, rounded to bf16), then
    the 3×3/2 max-pool, + b in float32 rounded to bf16, relu.
  * The features are the float32 mean of the last bf16 map.
"""

from typing import Dict, Mapping, Optional

import torch
from torch.nn import functional as F

Tensor = torch.Tensor
BF16 = torch.bfloat16


def fold(sd: Mapping[str, Tensor], conv: str, bn: str):
    s = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + 1e-5)
    return (sd[f"{conv}.weight"].float() * s.reshape(-1, 1, 1, 1),
            sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * s)


def quantize_weight(w: Tensor, levels: int):
    """(O, I, kh, kw) float32 → (integer-valued float64 OIHW, (O,) float32 scale)."""
    k = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    scale = (k.abs().amax(dim=1) / float(levels)).clamp_min(1e-12)
    q = torch.round(k / scale[:, None]).clamp_(-levels, levels)
    return q.reshape(w.shape[0], w.shape[2], w.shape[3], w.shape[1]).permute(0, 3, 1, 2).double(), scale


def quantize_act(x: Tensor, s: Tensor, levels: int) -> Tensor:
    """x (bf16 or float32) at the 0-dim float32 scale ``s`` → integer-valued float32."""
    return torch.round(x.float() / s).clamp_(-levels, levels)


class Int8Trunk:
    """The quantized trunk of one state dict (NCHW inside, NHWC in and out)."""

    def __init__(self, sd: Mapping[str, Tensor], trunk_cfg: Mapping, levels: int = 127,
                 prefix: str = "trunk."):
        self.levels, self.blocks = levels, trunk_cfg["blocks"]
        p = prefix
        w, b = fold(sd, p + "conv1", p + "bn1")
        self.stem = (w.to(BF16), b)
        self.k_stem = trunk_cfg["stem_kernel"]
        self.convs = {}
        for s, blocks in enumerate(self.blocks, start=1):
            for blk in range(blocks):
                q = f"{p}layer{s}.{blk}."
                names = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
                if blk == 0:
                    names.append(("downsample.0", "downsample.1"))
                for conv, bn in names:
                    wf, bias = fold(sd, q + conv, q + bn)
                    wq, ws = quantize_weight(wf, levels)
                    self.convs[f"layer{s}_{blk}/{conv.split('.')[0].replace('downsample', 'proj')}"] = (
                        wq, ws, bias)

    def _stem(self, x: Tensor) -> Tensor:
        w, b = self.stem
        h = F.conv2d(x.permute(0, 3, 1, 2).to(BF16), w, stride=2, padding=self.k_stem // 2)
        return F.max_pool2d(h, 3, stride=2, padding=1).add_(b[:, None, None]).relu_()

    def _conv(self, xq: Tensor, xs: Tensor, name: str, stride: int = 1, relu: bool = False,
              res: Optional[Tensor] = None) -> Tensor:
        """One quantized conv of the integer-valued ``xq`` at scale ``xs`` → bf16."""
        wq, ws, b = self.convs[name]
        acc = F.conv2d(xq.double(), wq, stride=stride, padding=wq.shape[-1] // 2)
        m = xs * ws
        v = acc.float() * m[:, None, None] + b[:, None, None]
        if res is not None:
            v = v.to(BF16).float() + res.float()
        if relu:
            v = torch.relu(v)
        return v.to(BF16)

    def __call__(self, x: Tensor, scales: Optional[Dict[str, Tensor]] = None,
                 collect: Optional[Dict[str, float]] = None) -> Tensor:
        """(N, H, W, 3) float32 → (N, 2048) float32. Without ``scales`` every
        conv input takes its own scale, recorded in ``collect``."""
        L = self.levels

        def q(h, name):
            if scales is None:
                s = (h.float().abs().amax() / float(L)).clamp_min(1e-12)
                if collect is not None:
                    collect[name] = float(s)
            else:
                s = scales[name]
            return quantize_act(h, s, L), s

        h = self._stem(x)
        for st, blocks in enumerate(self.blocks, start=1):
            for blk in range(blocks):
                n = f"layer{st}_{blk}"
                stride = 2 if (st > 1 and blk == 0) else 1
                res = h
                if blk == 0:
                    res = self._conv(*q(h, f"{n}/proj"), f"{n}/proj", stride)
                y = self._conv(*q(h, f"{n}/conv1"), f"{n}/conv1", relu=True)
                y = self._conv(*q(y, f"{n}/conv2"), f"{n}/conv2", stride, relu=True)
                h = self._conv(*q(y, f"{n}/conv3"), f"{n}/conv3", relu=True, res=res)
        return h.float().mean(dim=(2, 3))

    def calibrate(self, sample: Tensor) -> Dict[str, Tensor]:
        """The static scales of one dynamic forward over ``sample`` crops,
        as 0-dim float32 tensors."""
        collect: Dict[str, float] = {}
        self(sample, None, collect)
        return {k: torch.tensor(v, dtype=torch.float32, device=sample.device)
                for k, v in collect.items()}
