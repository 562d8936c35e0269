"""ResNet-50 feature trunk, eval mode (port of airpose_tpu/models/resnet.py).

Bottleneck [3, 4, 6, 3], 7×7/2 stem, 3×3/2 maxpool, global average pool →
2048-d feature. Module names follow the reference state dict (``conv1``,
``bn1``, ``layer{s}.{b}.conv{i}``, ``.bn{i}``, ``.downsample.0/1``).

The dtype policy is flax's: parameters stay f32, convolutions run in the
trunk's ``dtype`` (their weights cast at the call), BatchNorm computes in
f32 from the running statistics and rounds its output to the input dtype.
Public inputs and outputs are NHWC, as in the JAX package; inside, the
NCHW views of NHWC tensors are channels_last, which cuDNN prefers.
"""

import torch
from torch import nn
from torch.nn import functional as F


class Conv2d(nn.Conv2d):
    """Conv2d with f32 parameters that runs in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)  # flax momentum 0.9


class Bottleneck(nn.Module):
    """1×1 → 3×3(stride) → 1×1(×4) with identity/projection shortcut."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        # explicit (1, 1) padding, also at stride 2 (lax "SAME" would pad (0, 1))
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            _bn(planes * 4),
        ) if project else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """(N, H, W, 3) → (N, 2048) GAP feature. ``part`` exposes the sub-graphs
    around layer1 so the inference path can splice in the fused layer1
    kernel (ops/fused_bottleneck.py) over the same parameters:
    'full', 'stem' ((N, H, W, 3) → (N, H/4, W/4, 64)), 'front' (stem +
    layer1 → (N, H/4, W/4, 256)) or 'tail' (layer1 output → (N, 2048))."""

    def __init__(self, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            layer = []
            for block in range(blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride, project=(block == 0)))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                # normal(0, sqrt(2 / fan_out)), as the JAX trunk's conv_init
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)

    def _stem(self, x):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        return self.maxpool(x)

    def _tail(self, x):
        x = self.layer4(self.layer3(self.layer2(x.to(self.dtype))))
        # jnp.mean over a bf16 map accumulates in f32 and rounds the mean to
        # bf16; the f32 IEF regressor then reads it as f32.
        return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype).float()

    def forward(self, x, part: str = "full"):
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last strides)
        if part == "tail":
            return self._tail(x)
        x = self._stem(x)
        if part == "stem":
            return x.permute(0, 2, 3, 1)
        x = self.layer1(x)
        if part == "front":
            return x.permute(0, 2, 3, 1)
        if part != "full":
            raise ValueError(f"unknown part {part!r}")
        return self._tail(x)
