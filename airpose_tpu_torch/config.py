"""Typed training configuration (copy of airpose_tpu/config.py:12-66): the
same fields with the same defaults, which replicate the reference AirPose
hyper-parameters."""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss-term weights of the supervised losses."""

    shape: float = 50.0          # per-vertex
    keypoint2d: float = 0.002
    keypoint3d: float = 1.0
    limbs3d: float = 3.0
    limbstheta: float = 1.0
    trans: float = 10.0
    rootrot: float = 1.0
    pose: float = 50.0
    beta: float = 1.0
    total_scale: float = 60.0


@dataclasses.dataclass(frozen=True)
class RealLossWeights:
    """Weights of the self-supervised fine-tune on real data."""

    keypoint2d: float = 0.001
    limbs2d: float = 1.5
    vposer: float = 1.0
    pose: float = 1.0      # cross-view pose consistency
    beta: float = 1.0
    total_scale: float = 60.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "copenet_twoview"
    lr: float = 5e-5                 # AMSGrad, weight decay 0
    batch_size: int = 30
    val_batch_size: int = 30
    reg_iters: int = 3               # IEF steps
    img_res: int = 224
    smpltrans_noise_sigma: Optional[float] = None  # GT + noise IEF trans init
    trans_scale: float = 0.05        # distance scaling of the IEF translation
    summary_steps: int = 500
    checkpoint_steps: int = 10000
    train_reg_only: bool = False     # freeze all but the regressor heads
    qat: bool = False                # STE fake-quant of the trunk convs (ops/qat.py)
    qat_levels: float = 127.0        # quant grid (127 = int8)
    qat_act: bool = False            # also fake-quant the trunk conv inputs
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    real_loss: RealLossWeights = dataclasses.field(default_factory=RealLossWeights)
    trunk_bf16: bool = True
    mesh_axes: Tuple[str, ...] = ("data",)
    seed: int = 123
