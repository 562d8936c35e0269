"""ResNet-50 feature trunk (port of airpose_tpu/models/resnet.py).

Bottleneck [3, 4, 6, 3], 7×7/2 stem, 3×3/2 maxpool, global average pool →
2048-d feature. Module names follow the reference state dict (``conv1``,
``bn1``, ``layer{s}.{b}.conv{i}``, ``.bn{i}``, ``.downsample.0/1``).

The dtype policy is flax's: parameters stay f32, convolutions run in the
trunk's ``dtype`` (their weights cast at the call), BatchNorm computes in
f32 and rounds its output to the input dtype. Public inputs and outputs are
NHWC, as in the JAX package; inside, the NCHW views of NHWC tensors are
channels_last, which cuDNN prefers.

Train or eval mode is the ``train`` argument of ``forward``, as in flax;
``nn.Module.training`` is not read, so ``.train()`` and ``.eval()`` change
nothing here or in the models built on the trunk. In train mode BatchNorm normalizes with
the batch statistics and updates its running statistics as flax does.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.qat import fake_quant_act
from ..parallel.mesh import active_group, global_batch_norm


class Conv2d(nn.Conv2d):
    """Conv2d with f32 parameters that runs in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    Train mode normalizes with the biased batch variance in f32 (torch's
    batch_norm; on the card its native channels-last kernels take the bf16
    input with f32 statistics and parameters) and moves the running
    statistics by ``0.9·running + 0.1·batch``, as flax does. torch's own
    update writes the *unbiased* batch variance n/(n−1)·var: this module
    lets torch update a copy of ``running_var`` (autograd keeps that copy
    for the backward, so it must not change afterwards) and then corrects
    what torch wrote back to the biased variance flax keeps, with no pass
    over the activations.
    ``num_batches_tracked`` is not counted (flax has no such counter).
    Under ``parallel.data_parallel`` with more than one rank, train mode
    normalizes with the global batch's statistics instead
    (``parallel.global_batch_norm``), as GSPMD's BatchNorm does."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)  # flax momentum 0.9

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        group = active_group()
        if group is not None:
            return global_batch_norm(x, self.weight, self.bias, self.running_mean,
                                     self.running_var, self.momentum, self.eps, group)
        m, c = self.momentum, 1.0 - x.shape[1] / x.numel()  # c = (n − 1) / n
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True,
                         m, self.eps)
        with torch.no_grad():
            # updated = (1−m)·old + m·var·n/(n−1); want (1−m)·old + m·var
            #         = (1−m)·(1−c)·old + c·updated
            self.running_var.mul_((1.0 - m) * (1.0 - c)).add_(updated, alpha=c)
        return y


class Bottleneck(nn.Module):
    """1×1 → 3×3(stride) → 1×1(×4) with identity/projection shortcut.

    ``act_fq`` (activation QAT, ops/qat.py): None, a grid ``levels``
    (dynamic per-batch abs-max scales) or ``(levels, scales)`` with frozen
    per-site steps keyed ``'{site}/conv1'`` … ``'{site}/proj'``, ``site``
    being the block's JAX name (``layer1_0``). It fake-quantizes the input
    of every conv, the points where the deployed int8 trunk quantizes; the
    identity shortcut carries the unquantized activation."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 project: bool = False, act_fq=None, site: str = ""):
        super().__init__()
        self.act_fq, self.site = act_fq, site
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        # explicit (1, 1) padding, also at stride 2 (lax "SAME" would pad (0, 1))
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4),
        ) if project else None

    def _fq(self, t, conv: str):
        if self.act_fq is None:
            return t
        if isinstance(self.act_fq, tuple):
            levels, scales = self.act_fq
            return fake_quant_act(t, levels, scale=scales[f"{self.site}/{conv}"])
        return fake_quant_act(t, self.act_fq)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(self._fq(x, "conv1")), train))
        y = F.relu(self.bn2(self.conv2(self._fq(y, "conv2")), train))
        y = self.bn3(self.conv3(self._fq(y, "conv3")), train)
        if self.downsample is None:
            residual = x
        else:
            conv, bn = self.downsample
            residual = bn(conv(self._fq(x, "proj")), train)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """(N, H, W, 3) → (N, 2048) GAP feature. ``part`` exposes the sub-graphs
    around layer1 so the inference path can splice in the fused layer1
    kernel (ops/fused_bottleneck.py) over the same parameters:
    'full', 'stem' ((N, H, W, 3) → (N, H/4, W/4, 64)), 'front' (stem +
    layer1 → (N, H/4, W/4, 256)) or 'tail' (layer1 output → (N, 2048)).
    ``act_fq`` goes to every block (the stem is excluded, as deployment
    keeps it bf16)."""

    def __init__(self, dtype=torch.float32, generator=None, act_fq=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            layer = []
            for block in range(blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride, project=(block == 0),
                                        act_fq=act_fq, site=f"layer{stage + 1}_{block}"))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                # normal(0, sqrt(2 / fan_out)), as the JAX trunk's conv_init
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)

    def _stem(self, x, train: bool):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        return self.maxpool(x)

    def _layers(self, x, train: bool, first: int, last: int):
        for stage in range(first, last + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return x

    def _tail(self, x, train: bool):
        x = self._layers(x.to(self.dtype), train, 2, 4)
        # jnp.mean over a bf16 map accumulates in f32 and rounds the mean to
        # bf16; the f32 IEF regressor then reads it as f32.
        return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype).float()

    def forward(self, x, part: str = "full", train: bool = False):
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last strides)
        if part == "tail":
            return self._tail(x, train)
        x = self._stem(x, train)
        if part == "stem":
            return x.permute(0, 2, 3, 1)
        x = self._layers(x, train, 1, 1)
        if part == "front":
            return x.permute(0, 2, 3, 1)
        if part != "full":
            raise ValueError(f"unknown part {part!r}")
        return self._tail(x, train)
