"""AirPoseTwoView, the AirPose network (port of airpose_tpu/models/airpose.py).

Two views, shared weights, full-perspective camera. The views are a
leading axis folded into the batch for the trunk, and the cross-view
exchange is a flip of the view axis. State per view = [trans(3) | root 6D
| 21×6D]; the fc1 concat order matches the reference checkpoint layout
column for column:
  [xf | bb(3) | trans(3) | orient(6) | art(126) | shape(10) |
   other art(126) | other shape(10)]
"""

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import constants as C
from .regressor import RegressorCore, load_mean_params
from .resnet import ResNet50

FEAT_DIM = 2048
FC1_IN = FEAT_DIM + 3 + 3 + 6 + 126 + 10 + 126 + 10  # 2332


class FullCamOutput(NamedTuple):
    pose: torch.Tensor   # (..., 135)  [trans(3) | root 6D | 21×6D]
    betas: torch.Tensor  # (..., 10)


def _flip_views(a: torch.Tensor) -> torch.Tensor:
    """Exchange the two views' tensors: (B, 2, ...) → peer-ordered."""
    return a.flip(1)


class AirPoseTwoView(nn.Module):
    """``forward(images (B, 2, H, W, 3), bb (B, 2, 3), init_position
    (B, 2, 3)) → FullCamOutput`` with pose (B, 2, 135), betas (B, 2, 10).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``; the
    mean-parameter IEF initialization is held as the buffers ``init_pose``
    (1, 144), ``init_shape`` (1, 10) and ``init_cam`` (1, 3), as in the
    reference state dict. ``act_fq`` is the trunk's activation-QAT grid
    (models/resnet.py). ``train=True`` runs BatchNorm on batch statistics
    (updating the running ones) and dropout with masks from ``generator``."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.trunk = ResNet50(dtype=dtype, generator=g, act_fq=act_fq)
        self.core = RegressorCore(FC1_IN, (135, 10), ("decpose", "decshape"),
                                  generator=g)
        pose, shape, cam = load_mean_params()
        self.register_buffer("init_pose", torch.from_numpy(pose)[None])
        self.register_buffer("init_shape", torch.from_numpy(shape)[None])
        self.register_buffer("init_cam", torch.from_numpy(cam)[None])

    def _reg(self, xf, bb, pose, shape, train, generator):
        """One IEF step over (B, 2, ·) state."""
        B, V = pose.shape[:2]
        trans, orient, art = pose[..., :3], pose[..., 3:9], pose[..., 9:]
        xc = torch.cat(
            [xf, bb, trans, orient, art, shape, _flip_views(art), _flip_views(shape)],
            dim=-1,
        )
        dp, ds = self.core(xc.reshape(B * V, -1), train, generator)
        return pose + dp.reshape(B, V, -1), shape + ds.reshape(B, V, -1)

    def forward(self, images: torch.Tensor, bb: torch.Tensor,
                init_position: torch.Tensor, init_theta: Optional[torch.Tensor] = None,
                init_shape: Optional[torch.Tensor] = None, iters: Optional[int] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> FullCamOutput:
        B, V = images.shape[:2]
        xf = self.trunk(images.reshape((B * V,) + images.shape[2:]),
                        train=train).reshape(B, V, -1)
        return self.from_features(xf, bb, init_position, init_theta, init_shape,
                                  iters, train, generator)

    def from_features(self, xf: torch.Tensor, bb: torch.Tensor,
                      init_position: torch.Tensor, init_theta: Optional[torch.Tensor] = None,
                      init_shape: Optional[torch.Tensor] = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> FullCamOutput:
        """IEF regression from precomputed (B, 2, 2048) trunk features: the
        injection point for the fused-layer1 trunk (ops/fused_bottleneck.py).
        The state starts from ``init_theta`` (B, 2, 132) and ``init_shape``
        (B, 2, 10), by default the mean pose and shape, and takes ``iters``
        steps (default C.NUM_ITERS)."""
        B, V = xf.shape[:2]
        theta = self.init_pose[:, : 22 * 6].expand(B, V, -1) if init_theta is None else init_theta
        pose = torch.cat([init_position, theta], dim=-1)
        shape = self.init_shape.expand(B, V, -1) if init_shape is None else init_shape
        for _ in range(iters or C.NUM_ITERS):
            pose, shape = self._reg(xf, bb, pose, shape, train, generator)
        return FullCamOutput(pose=pose, betas=shape)

    # ---- staged API for the 3-step serving protocol ----

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 224, 224, 3) → (B, 2048), single view."""
        return self.trunk(x)

    def regress_step(
        self,
        xf: torch.Tensor,
        bb: torch.Tensor,
        own_pose: torch.Tensor,
        own_shape: torch.Tensor,
        peer_art_pose: torch.Tensor,
        peer_shape: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One single-view IEF step with an explicit peer state: the unit
        the drones exchange over the network."""
        trans, orient, art = own_pose[..., :3], own_pose[..., 3:9], own_pose[..., 9:]
        xc = torch.cat(
            [xf, bb, trans, orient, art, own_shape, peer_art_pose, peer_shape],
            dim=-1,
        )
        dp, ds = self.core(xc)
        return own_pose + dp, own_shape + ds
