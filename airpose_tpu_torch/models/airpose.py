"""The AirPose model families (port of airpose_tpu/models/airpose.py).

  HMR                 single view, weak-perspective camera ("Baseline")
  SingleViewFullCam   single view, full-perspective camera
  MuHMR               two views, shared weights, weak-perspective cameras
  AirPoseTwoView      two views, shared weights, full perspective ("AirPose")
  AirPoseTwoViewSep   two views, one trunk and regressor per drone

Two-view models fold the views into the batch for a shared trunk, and the
cross-view exchange is a flip of the view axis. Each family's fc1 concat
order matches its reference checkpoint layout column for column:
  HMR         [xf | pose 6D(132) | shape(10) | cam(3)]
  SingleView  [xf | bb(3) | trans(3) | pose 6D(132) | shape(10)]
  MuHMR       [xf | cam(3) | orient(6) | art(126) | shape(10) | other art | other shape]
  TwoView     [xf | bb(3) | trans(3) | orient(6) | art(126) | shape(10) |
               other art(126) | other shape(10)]

Weights are drawn from a ``torch.Generator`` seeded with ``seed``. Each
model holds the mean-parameter buffers of its reference state dict:
``init_pose`` (1, 144) and ``init_shape`` (1, 10), with ``init_cam`` (1, 3)
or, for the single-view model, ``init_position`` (1, 3); the per-drone model
holds them per drone, on ``core0`` and ``core1``. ``iters`` is the number of
IEF steps unless a call passes its own. ``act_fq`` is the trunk's
activation-QAT grid (models/resnet.py). ``train=True`` runs BatchNorm on
batch statistics (updating the running ones) and dropout with masks from
``generator``.
"""

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import constants as C
from .. import resolve_device
from .regressor import RegressorCore, load_mean_params
from .resnet import ResNet50

FEAT_DIM = 2048
FC1_IN = FEAT_DIM + 3 + 3 + 6 + 126 + 10 + 126 + 10  # 2332, the two-view models
WEAK_HEADS = ((132, 10, 3), ("decpose", "decshape", "deccam"))
FULL_HEADS = ((135, 10), ("decpose", "decshape"))

Tensor = torch.Tensor
OptTensor = Optional[torch.Tensor]


class WeakCamOutput(NamedTuple):
    pose6d: Tensor  # (..., 132)  22 joints × 6D (root + 21 body)
    betas: Tensor   # (..., 10)
    cam: Tensor     # (..., 3)    weak-perspective (s, tx, ty)


class FullCamOutput(NamedTuple):
    pose: Tensor    # (..., 135)  [trans(3) | root 6D | 21×6D]
    betas: Tensor   # (..., 10)


def mean_init_state(batch_shape=(), device=None) -> Tuple[Tensor, Tensor, Tensor]:
    """(pose 6D (132,), shape (10,), cam (3,)) mean-parameter IEF start,
    broadcast to ``batch_shape``, on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    pose, shape, cam = (torch.from_numpy(a).to(dev) for a in load_mean_params())
    return tuple(t.expand(tuple(batch_shape) + t.shape) for t in (pose[:132], shape, cam))


def _register_mean_buffers(module: nn.Module, extra: str = "init_cam") -> None:
    """The reference net's mean-parameter buffers: ``init_pose``,
    ``init_shape`` and ``extra``, the mean camera ``init_cam`` or the
    single-view model's ``init_position`` [0, 0, 10 / 0.05]."""
    pose, shape, cam = load_mean_params()
    module.register_buffer("init_pose", torch.from_numpy(pose)[None])
    module.register_buffer("init_shape", torch.from_numpy(shape)[None])
    if extra == "init_cam":
        module.register_buffer("init_cam", torch.from_numpy(cam)[None])
    else:
        module.register_buffer("init_position", torch.tensor([[0.0, 0.0, 10.0 / 0.05]]))


def _mean(buf: Tensor, batch_shape, n: Optional[int] = None) -> Tensor:
    """A (1, k) mean buffer's first ``n`` values, broadcast to ``batch_shape``."""
    v = buf[0, :n]
    return v.expand(tuple(batch_shape) + v.shape)


def _flip_views(a: Tensor) -> Tensor:
    """Exchange the two views' tensors: (B, 2, ...) → peer-ordered."""
    return a.flip(1)


def _regress_step(core: RegressorCore, xf, bb, own_pose, own_shape, peer_art_pose,
                  peer_shape) -> Tuple[Tensor, Tensor]:
    """One eval-mode single-view IEF step of a full-camera two-view model
    with an explicit peer state."""
    xc = torch.cat([xf, bb, own_pose, own_shape, peer_art_pose, peer_shape], dim=-1)
    dp, ds = core(xc)
    return own_pose + dp, own_shape + ds


class _IEFModel(nn.Module):
    """One trunk and one regressor core with ``heads`` = (dims, names)."""

    def __init__(self, fc1_in: int, heads, dtype, seed: int, act_fq, iters: int,
                 extra: str = "init_cam"):
        super().__init__()
        self.iters = iters
        g = torch.Generator().manual_seed(seed)
        self.trunk = ResNet50(dtype=dtype, generator=g, act_fq=act_fq)
        self.core = RegressorCore(fc1_in, *heads, generator=g)
        _register_mean_buffers(self, extra)

    def _views_features(self, images: Tensor, train: bool) -> Tensor:
        """(B, V, H, W, 3) → (B, V, 2048), the views folded into the batch."""
        B, V = images.shape[:2]
        return self.trunk(images.reshape((B * V,) + images.shape[2:]),
                          train=train).reshape(B, V, -1)


class HMR(_IEFModel):
    """``forward(x (B, H, W, 3)) → WeakCamOutput`` with pose6d (B, 132),
    betas (B, 10), cam (B, 3)."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS):
        super().__init__(FEAT_DIM + 132 + 10 + 3, WEAK_HEADS, dtype, seed, act_fq, iters)

    def forward(self, x: Tensor, init_cam: OptTensor = None, init_theta: OptTensor = None,
                init_shape: OptTensor = None, iters: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> WeakCamOutput:
        return self.from_features(self.trunk(x, train=train), init_cam, init_theta, init_shape,
                                  iters, train, generator)

    def from_features(self, xf: Tensor, init_cam: OptTensor = None,
                      init_theta: OptTensor = None, init_shape: OptTensor = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> WeakCamOutput:
        """IEF from precomputed (B, 2048) trunk features."""
        B = xf.shape[:1]
        pose = _mean(self.init_pose, B, 132) if init_theta is None else init_theta
        shape = _mean(self.init_shape, B) if init_shape is None else init_shape
        cam = _mean(self.init_cam, B) if init_cam is None else init_cam
        for _ in range(iters or self.iters):
            dp, ds, dc = self.core(torch.cat([xf, pose, shape, cam], dim=-1), train, generator)
            pose, shape, cam = pose + dp, shape + ds, cam + dc
        return WeakCamOutput(pose6d=pose, betas=shape, cam=cam)

    def extract_features(self, x: Tensor) -> Tensor:
        return self.trunk(x)


class SingleViewFullCam(_IEFModel):
    """``forward(x (B, H, W, 3), bb (B, 3), init_position (B, 3)) →
    FullCamOutput`` with pose (B, 135) [trans | 22×6D], betas (B, 10)."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS):
        super().__init__(FEAT_DIM + 3 + 135 + 10, FULL_HEADS, dtype, seed, act_fq, iters,
                         extra="init_position")

    def forward(self, x: Tensor, bb: Tensor, init_position: Tensor,
                init_theta: OptTensor = None, init_shape: OptTensor = None,
                iters: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> FullCamOutput:
        return self.from_features(self.trunk(x, train=train), bb, init_position, init_theta,
                                  init_shape, iters, train, generator)

    def from_features(self, xf: Tensor, bb: Tensor, init_position: Tensor,
                      init_theta: OptTensor = None, init_shape: OptTensor = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> FullCamOutput:
        """IEF from precomputed (B, 2048) trunk features."""
        B = xf.shape[:1]
        theta = _mean(self.init_pose, B, 132) if init_theta is None else init_theta
        pose = torch.cat([init_position, theta], dim=-1)
        shape = _mean(self.init_shape, B) if init_shape is None else init_shape
        for _ in range(iters or self.iters):
            dp, ds = self.core(torch.cat([xf, bb, pose, shape], dim=-1), train, generator)
            pose, shape = pose + dp, shape + ds
        return FullCamOutput(pose=pose, betas=shape)


class MuHMR(_IEFModel):
    """``forward(images (B, 2, H, W, 3)) → WeakCamOutput`` with pose6d
    (B, 2, 132), betas (B, 2, 10), cam (B, 2, 3)."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS):
        super().__init__(FEAT_DIM + 3 + 6 + 126 + 10 + 126 + 10, WEAK_HEADS, dtype, seed,
                         act_fq, iters)

    def forward(self, images: Tensor, init_cam: OptTensor = None,
                init_theta: OptTensor = None, init_shape: OptTensor = None,
                iters: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> WeakCamOutput:
        return self.from_features(self._views_features(images, train), init_cam, init_theta,
                                  init_shape, iters, train, generator)

    def from_features(self, xf: Tensor, init_cam: OptTensor = None,
                      init_theta: OptTensor = None, init_shape: OptTensor = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> WeakCamOutput:
        """IEF from precomputed (B, 2, 2048) trunk features."""
        B, V = xf.shape[:2]
        pose = _mean(self.init_pose, (B, V), 132) if init_theta is None else init_theta
        shape = _mean(self.init_shape, (B, V)) if init_shape is None else init_shape
        cam = _mean(self.init_cam, (B, V)) if init_cam is None else init_cam
        for _ in range(iters or self.iters):
            art = pose[..., 6:]
            xc = torch.cat([xf, cam, pose, shape, _flip_views(art), _flip_views(shape)], dim=-1)
            dp, ds, dc = self.core(xc.reshape(B * V, -1), train, generator)
            pose = pose + dp.reshape(B, V, -1)
            shape = shape + ds.reshape(B, V, -1)
            cam = cam + dc.reshape(B, V, -1)
        return WeakCamOutput(pose6d=pose, betas=shape, cam=cam)


class AirPoseTwoView(_IEFModel):
    """``forward(images (B, 2, H, W, 3), bb (B, 2, 3), init_position
    (B, 2, 3)) → FullCamOutput`` with pose (B, 2, 135), betas (B, 2, 10)."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS):
        super().__init__(FC1_IN, FULL_HEADS, dtype, seed, act_fq, iters)

    def forward(self, images: Tensor, bb: Tensor, init_position: Tensor,
                init_theta: OptTensor = None, init_shape: OptTensor = None,
                iters: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> FullCamOutput:
        return self.from_features(self._views_features(images, train), bb, init_position,
                                  init_theta, init_shape, iters, train, generator)

    def from_features(self, xf: Tensor, bb: Tensor, init_position: Tensor,
                      init_theta: OptTensor = None, init_shape: OptTensor = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> FullCamOutput:
        """IEF regression from precomputed (B, 2, 2048) trunk features: the
        injection point for the fused-layer1 and int8 trunks. The state
        starts from ``init_theta`` (B, 2, 132) and ``init_shape``
        (B, 2, 10), by default the mean pose and shape."""
        B, V = xf.shape[:2]
        theta = _mean(self.init_pose, (B, V), 132) if init_theta is None else init_theta
        pose = torch.cat([init_position, theta], dim=-1)
        shape = _mean(self.init_shape, (B, V)) if init_shape is None else init_shape
        for _ in range(iters or self.iters):
            xc = torch.cat([xf, bb, pose, shape, _flip_views(pose[..., 9:]),
                            _flip_views(shape)], dim=-1)
            dp, ds = self.core(xc.reshape(B * V, -1), train, generator)
            pose, shape = pose + dp.reshape(B, V, -1), shape + ds.reshape(B, V, -1)
        return FullCamOutput(pose=pose, betas=shape)

    # ---- staged API for the 3-step serving protocol ----

    def extract_features(self, x: Tensor) -> Tensor:
        """(B, 224, 224, 3) → (B, 2048), single view."""
        return self.trunk(x)

    def regress_step(self, xf: Tensor, bb: Tensor, own_pose: Tensor, own_shape: Tensor,
                     peer_art_pose: Tensor, peer_shape: Tensor) -> Tuple[Tensor, Tensor]:
        """One single-view IEF step with an explicit peer state: the unit
        the drones exchange over the network."""
        return _regress_step(self.core, xf, bb, own_pose, own_shape, peer_art_pose, peer_shape)


class AirPoseTwoViewSep(nn.Module):
    """AirPose with per-drone weights: ``trunk{v}`` and ``core{v}`` for view
    v, the mean-parameter buffers on each core. Same call and outputs as
    AirPoseTwoView. ``act_fq`` may be ``(levels, (table0, table1))``, one
    frozen activation-scale table per trunk.

    Both views update from the same pre-step state in each IEF step, as
    the shared-weight model does and the staged serving protocol needs; the
    reference's per-drone forward updates view 0's shape before it builds
    view 1's input, which ``AirPoseTwoViewSepView.regress_step`` can
    reproduce step by step."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS):
        super().__init__()
        self.iters = iters
        fq = (act_fq, act_fq)
        if isinstance(act_fq, tuple) and isinstance(act_fq[1], (tuple, list)):
            levels, tables = act_fq
            fq = tuple((levels, t) for t in tables)
        g = torch.Generator().manual_seed(seed)
        self.trunk0 = ResNet50(dtype=dtype, generator=g, act_fq=fq[0])
        self.trunk1 = ResNet50(dtype=dtype, generator=g, act_fq=fq[1])
        self.core0 = RegressorCore(FC1_IN, *FULL_HEADS, generator=g)
        self.core1 = RegressorCore(FC1_IN, *FULL_HEADS, generator=g)
        for core in (self.core0, self.core1):
            _register_mean_buffers(core)

    def forward(self, images: Tensor, bb: Tensor, init_position: Tensor,
                init_theta: OptTensor = None, init_shape: OptTensor = None,
                iters: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> FullCamOutput:
        xf = torch.stack([self.trunk0(images[:, 0], train=train),
                          self.trunk1(images[:, 1], train=train)], dim=1)
        return self.from_features(xf, bb, init_position, init_theta, init_shape, iters, train,
                                  generator)

    def from_features(self, xf: Tensor, bb: Tensor, init_position: Tensor,
                      init_theta: OptTensor = None, init_shape: OptTensor = None,
                      iters: Optional[int] = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> FullCamOutput:
        """IEF regression from precomputed (B, 2, 2048) per-drone features,
        each view through its own core."""
        B = xf.shape[:1]
        cores = (self.core0, self.core1)
        if init_theta is None:
            init_theta = torch.stack([_mean(c.init_pose, B, 132) for c in cores], dim=1)
        if init_shape is None:
            init_shape = torch.stack([_mean(c.init_shape, B) for c in cores], dim=1)
        pose, shape = torch.cat([init_position, init_theta], dim=-1), init_shape
        for _ in range(iters or self.iters):
            xc = torch.cat([xf, bb, pose, shape, _flip_views(pose[..., 9:]),
                            _flip_views(shape)], dim=-1)
            deltas = [core(xc[:, v], train, generator) for v, core in enumerate(cores)]
            pose = pose + torch.stack([d[0] for d in deltas], dim=1)
            shape = shape + torch.stack([d[1] for d in deltas], dim=1)
        return FullCamOutput(pose=pose, betas=shape)


class AirPoseTwoViewSepView(AirPoseTwoViewSep):
    """Staged single-view access into AirPoseTwoViewSep's per-drone weights
    (the same tree, so a ``_sep`` state dict loads as is): each drone runs
    trunk ``view`` and core ``view``. ``forward`` is ``extract_features``."""

    def __init__(self, dtype=torch.float32, seed: int = 0, act_fq=None,
                 iters: int = C.NUM_ITERS, view: int = 0):
        super().__init__(dtype, seed, act_fq, iters)
        if view not in (0, 1):
            raise ValueError(f"view must be 0 or 1, got {view}")
        self.view = view

    def forward(self, x: Tensor) -> Tensor:
        return self.extract_features(x)

    def extract_features(self, x: Tensor) -> Tensor:
        """(B, H, W, 3) → (B, 2048) through this drone's trunk."""
        return getattr(self, f"trunk{self.view}")(x)

    def regress_step(self, xf: Tensor, bb: Tensor, own_pose: Tensor, own_shape: Tensor,
                     peer_art_pose: Tensor, peer_shape: Tensor) -> Tuple[Tensor, Tensor]:
        """One IEF step of this drone's core with an explicit peer state."""
        return _regress_step(getattr(self, f"core{self.view}"), xf, bb, own_pose, own_shape,
                             peer_art_pose, peer_shape)
