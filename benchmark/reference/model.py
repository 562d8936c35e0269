"""Plain AirPose and HMR: the bf16 ResNet-50 trunk, the IEF regressors, the
synthetic supervised losses and AMSGrad, over a state dict.

The numerics are the configuration's: convolutions in the trunk's dtype
(bf16) with float32 parameters cast at the call and float32 BatchNorm
statistics, the global average pool summed in float32 and rounded to the
trunk's dtype, everything after the trunk in float32 with TF32 off. In
train mode BatchNorm normalises with the batch's statistics, and the
regressor's dropout (rate 0.5 after fc1 and after fc2, in each IEF step)
draws its masks with ``bernoulli_`` on the device from the generator the
step is given, in that order.
"""

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from . import smplx

Tensor = torch.Tensor

FOCAL = (1475.0, 1475.0)          # the synthetic camera, pixels
TRANS_SCALE = 0.05                # the IEF state's scaling of translations
LIMB_JOINTS = ((4, 5, 18, 19), (7, 8, 20, 21))      # knees, elbows; ankles, wrists
LIMB_ROTMATS = ((3, 4, 17, 18), (6, 7, 19, 20))     # the same without the root


def no_tf32() -> None:
    """Full float32 products: the reference's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- trunk -------------------------------------------------------------------------

def _bn(x: Tensor, sd: Mapping[str, Tensor], name: str, train: bool) -> Tensor:
    if train:
        return F.batch_norm(x, sd[f"{name}.running_mean"].clone(),
                            sd[f"{name}.running_var"].clone(), sd[f"{name}.weight"],
                            sd[f"{name}.bias"], True, 0.1, 1e-5)
    return F.batch_norm(x, sd[f"{name}.running_mean"], sd[f"{name}.running_var"],
                        sd[f"{name}.weight"], sd[f"{name}.bias"], False, 0.0, 1e-5)


def _conv(x: Tensor, w: Tensor, stride: int = 1, padding: int = 0) -> Tensor:
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def trunk(sd: Mapping[str, Tensor], trunk_cfg: Mapping, x: Tensor, dtype: torch.dtype,
          train: bool, prefix: str = "trunk.") -> Tensor:
    """(N, H, W, 3) float32 → (N, 2048) float32 features."""
    p = prefix
    h = x.permute(0, 3, 1, 2).to(dtype)
    k = trunk_cfg["stem_kernel"]
    h = F.relu(_bn(_conv(h, sd[p + "conv1.weight"], 2, k // 2), sd, p + "bn1", train))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for s, blocks in enumerate(trunk_cfg["blocks"], start=1):
        for b in range(blocks):
            q = f"{p}layer{s}.{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            y = F.relu(_bn(_conv(h, sd[q + "conv1.weight"]), sd, q + "bn1", train))
            y = F.relu(_bn(_conv(y, sd[q + "conv2.weight"], stride, 1), sd, q + "bn2", train))
            y = _bn(_conv(y, sd[q + "conv3.weight"]), sd, q + "bn3", train)
            res = h if b else _bn(_conv(h, sd[q + "downsample.0.weight"], stride), sd,
                                  q + "downsample.1", train)
            h = F.relu(y + res)
    return h.mean(dim=(2, 3), dtype=torch.float32).to(dtype).float()


# ---- IEF regressors ----------------------------------------------------------------

def _dropout(h: Tensor, generator: torch.Generator) -> Tensor:
    return h * torch.empty_like(h).bernoulli_(0.5, generator=generator) / 0.5


def regressor_core(sd: Mapping[str, Tensor], heads: Sequence[str], xc: Tensor,
                   generator: Optional[torch.Generator]) -> Tuple[Tensor, ...]:
    """fc1 → dropout → fc2 → dropout → one Linear per head; dropout only
    with a generator (train mode)."""
    h = F.linear(xc, sd["core.fc1.weight"], sd["core.fc1.bias"])
    if generator is not None:
        h = _dropout(h, generator)
    h = F.linear(h, sd["core.fc2.weight"], sd["core.fc2.bias"])
    if generator is not None:
        h = _dropout(h, generator)
    return tuple(F.linear(h, sd[f"core.{n}.weight"], sd[f"core.{n}.bias"]) for n in heads)


def _flip(a: Tensor) -> Tensor:
    return a.flip(1)


def twoview_ief(sd, cfg, xf: Tensor, bb: Tensor, init_position: Tensor,
                generator=None, init=None) -> Tuple[Tensor, Tensor]:
    """AirPose's IEF: each view's regressor reads its own state and the
    other view's articulated pose and shape. xf (B, 2, 2048), bb and
    init_position (B, 2, 3) → pose (B, 2, 135) [trans·scale | 22 × 6D],
    betas (B, 2, 10). The state starts from the model's mean-parameter
    buffers, or from ``init`` = (6D pose (132,), shape (10,))."""
    B, V = xf.shape[:2]
    theta, shape = init or (sd["init_pose"][0, :132], sd["init_shape"][0])
    pose = torch.cat([init_position, theta.expand(B, V, 132)], dim=-1)
    shape = shape.expand(B, V, 10)
    for _ in range(cfg["ief_iters"]):
        xc = torch.cat([xf, bb, pose, shape, _flip(pose[..., 9:]), _flip(shape)], dim=-1)
        dp, ds = regressor_core(sd, cfg["heads"], xc.reshape(B * V, -1), generator)
        pose, shape = pose + dp.reshape(B, V, -1), shape + ds.reshape(B, V, -1)
    return pose, shape


def hmr_ief(sd, cfg, xf: Tensor, generator=None) -> Tuple[Tensor, Tensor, Tensor]:
    """HMR's IEF: xf (B, 2048) → pose 6D (B, 132), betas (B, 10), cam (B, 3)."""
    B = xf.shape[0]
    pose = sd["init_pose"][0, :132].expand(B, 132)
    shape = sd["init_shape"][0].expand(B, 10)
    cam = sd["init_cam"][0].expand(B, 3)
    for _ in range(cfg["ief_iters"]):
        dp, ds, dc = regressor_core(sd, cfg["heads"], torch.cat([xf, pose, shape, cam], -1),
                                    generator)
        pose, shape, cam = pose + dp, shape + ds, cam + dc
    return pose, shape, cam


# ---- projection and the SMPL-X forward of both views --------------------------------

def project(rot_root: Tensor, trans: Tensor, joints: Tensor, intr: Tensor) -> Tensor:
    """Canonical joints (B, V, N, 3) rotated by the root, translated, and
    projected with the synthetic focal length about ``intr``'s principal
    point → (B, V, N, 2)."""
    cam = torch.einsum("bvij,bvnj->bvni", rot_root, joints) + trans[:, :, None]
    xy = cam[..., :2] / cam[..., 2:]
    return xy * torch.tensor(FOCAL, dtype=xy.dtype, device=xy.device) + intr[..., :2, 2][:, :, None]


def twoview_bodies(body: Mapping[str, Tensor], pose: Tensor, betas: Tensor):
    """→ rotmats (B, 2, 22, 3, 3), canonical vertices (B, 2, V, 3) and joints
    (B, 2, 127, 3) of both views, one folded SMPL-X call."""
    B = pose.shape[0]
    rot = smplx.rot6d_to_rotmat(pose[..., 3:].reshape(B, 2, 22, 6))
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(B * 2, 1, 3, 3)
    verts, joints = smplx.forward(body, betas.reshape(B * 2, -1),
                                  rot[:, :, 1:].reshape(B * 2, 21, 3, 3), eye)
    return rot, verts.reshape(B, 2, -1, 3), joints.reshape(B, 2, -1, 3)


def perceive_tail(sd, cfg, body, xf: Tensor, bb, init_position, intr,
                  dtype: torch.dtype = torch.float32):
    """What follows the trunk in two-view perception: IEF, 6D → rotmats,
    SMPL-X, projection → (vertices (B, 2, V, 3), j2d (B, 2, 127, 2)) in
    float32, computed in ``dtype`` (the control runs it in bfloat16)."""
    if dtype != torch.float32:
        def cast(d):
            return {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}
        sd, body = cast(sd), cast(body)
        xf, bb, init_position, intr = (t.to(dtype) for t in (xf, bb, init_position, intr))
    pose, betas = twoview_ief(sd, cfg, xf, bb, init_position)
    rot, verts, joints = twoview_bodies(body, pose, betas)
    j2d = project(rot[:, :, 0], pose[..., :3] / TRANS_SCALE, joints, intr)
    return verts.float(), j2d.float()


# ---- losses ------------------------------------------------------------------------

def _sq(a, b):
    return (a - b) ** 2


def _limb(n: int, sets, w: float, like: Tensor) -> Tensor:
    f = torch.ones(n, dtype=like.dtype, device=like.device)
    f[list(sets[0])] = w
    f[list(sets[1])] = w ** 2
    return f


def twoview_loss(w: Mapping[str, float], body, pose: Tensor, betas: Tensor, batch) -> Tensor:
    """The synthetic two-view supervised loss of AirPose (weights ``w``)."""
    trans = pose[..., :3] / TRANS_SCALE
    rot, verts, joints = twoview_bodies(body, pose, betas)
    j2d = project(rot[:, :, 0], trans, joints, batch["intr"])
    kp2d = sum(_sq(j2d[:, v, :22], batch["gt_j2d"][:, v, :22]).mean() for v in (0, 1))
    j22, gtj = joints[:, :, :22], batch["gt_joints"][:, :22]
    e3d = _sq(j22[:, 0], gtj) + _sq(j22[:, 1], gtj) + _sq(j22[:, 0], j22[:, 1])
    kp3d = (e3d * _limb(22, LIMB_JOINTS, w["limbs3d"], e3d)[:, None]).mean()
    gtv = batch["gt_vertices"]
    shape = _sq(verts[:, 0], gtv).mean() + _sq(verts[:, 1], gtv).mean() + \
        _sq(verts[:, 0], verts[:, 1]).mean()
    trans_l = _sq(trans, batch["gt_trans"]).mean(dim=(0, 2)).sum()
    rootrot = sum(_sq(rot[:, v, 0], batch["gt_orient"][:, v]).mean() for v in (0, 1))
    gtp = batch["gt_pose_rotmat"]
    ep = _sq(rot[:, 0, 1:], gtp) + _sq(rot[:, 1, 1:], gtp) + _sq(rot[:, 0, 1:], rot[:, 1, 1:])
    pose_l = (ep * _limb(21, LIMB_ROTMATS, w["limbstheta"], ep)[:, None, None]).mean()
    beta_l = (betas[:, 0] ** 2).mean() + (betas[:, 1] ** 2).mean() + \
        _sq(betas[:, 0], betas[:, 1]).mean()
    return w["total_scale"] * (
        w["trans"] * trans_l + w["keypoint2d"] * kp2d + w["keypoint3d"] * kp3d
        + w["shape"] * shape + w["rootrot"] * rootrot + w["pose"] * pose_l + w["beta"] * beta_l)


def hmr_loss(w: Mapping[str, float], body, pose6d: Tensor, betas: Tensor, cam: Tensor,
             batch, img_res: int) -> Tensor:
    """HMR's loss on view 0: weak-perspective 2D keypoints in crop
    coordinates, 3D joints, vertices, root and body rotations, the betas
    prior and the camera-scale barrier."""
    B = pose6d.shape[0]
    rot = smplx.rot6d_to_rotmat(pose6d.reshape(B, 22, 6))
    eye = torch.eye(3, dtype=pose6d.dtype, device=pose6d.device).expand(B, 1, 3, 3)
    verts, joints = smplx.forward(body, betas, rot[:, 1:], eye)
    cam_t = torch.stack([cam[:, 1], cam[:, 2], 2 * FOCAL[0] / (img_res * cam[:, 0] + 1e-9)], -1)
    rj = torch.einsum("bij,bnj->bni", rot[:, 0], joints) + cam_t[:, None]
    j2d = rj[..., :2] / rj[..., 2:] * torch.tensor(FOCAL, dtype=rj.dtype, device=rj.device)
    kp2d = _sq(j2d[:, :22], batch["gt_j2d_crop"][:, 0, :22]).mean()
    e3d = _sq(joints[:, :22], batch["gt_joints"][:, :22])
    kp3d = (e3d * _limb(22, LIMB_JOINTS, w["limbs3d"], e3d)[:, None]).mean()
    shape = _sq(verts, batch["gt_vertices"]).mean()
    rootrot = _sq(rot[:, :1], batch["gt_orient"][:, :1]).mean()
    ep = _sq(rot[:, 1:], batch["gt_pose_rotmat"])
    pose_l = (ep * _limb(21, LIMB_ROTMATS, w["limbstheta"], ep)[:, None, None]).mean()
    barrier = (torch.exp(-cam[:, 0] * 10) ** 2).mean()
    return w["total_scale"] * (
        w["keypoint2d"] * kp2d + w["keypoint3d"] * kp3d + w["shape"] * shape
        + w["rootrot"] * rootrot + w["pose"] * pose_l + w["beta"] * (betas ** 2).mean() + barrier)


# ---- the training step ---------------------------------------------------------------

class AMSGrad:
    """Adam with AMSGrad as optax computes it: the running maximum of the
    bias-corrected second moment; bias corrections in float32."""

    def __init__(self, params: Mapping[str, Tensor], lr: float, b1: float, b2: float,
                 eps: float):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.vmax = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Mapping[str, Tensor]) -> None:
        self.t += 1
        t = np.float32(self.t)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        for n, g in grads.items():
            self.m[n].lerp_(g, 1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            self.vmax[n] = torch.maximum(self.vmax[n], self.v[n] / bc2)
            params[n].add_(self.m[n] / (self.vmax[n].sqrt() + self.eps), alpha=-self.lr / bc1)


def train_loss(sd: Mapping[str, Tensor], cfg: Mapping, body, batch,
               generator: torch.Generator, rows: Optional[slice] = None) -> Tensor:
    """One training forward of the configuration on ``batch`` → the loss.
    ``rows`` keeps part of the batch (the half-batch fault)."""
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
    dtype = getattr(torch, cfg["trunk_dtype"])
    if cfg["family"] == "hmr":
        x = batch["images"][:, 0]
        xf = trunk(sd, cfg["trunk"], x, dtype, True)
        pose6d, betas, cam = hmr_ief(sd, cfg, xf, generator)
        return hmr_loss(cfg["loss_weights"], body, pose6d, betas, cam, batch, x.shape[1])
    images = batch["images"]
    B = images.shape[0]
    xf = trunk(sd, cfg["trunk"], images.reshape((B * 2,) + images.shape[2:]), dtype,
               True).reshape(B, 2, -1)
    in_trans = torch.tensor([0.0, 0.0, 10.0 * TRANS_SCALE], device=images.device).expand(B, 2, 3)
    pose, betas = twoview_ief(sd, cfg, xf, batch["bb"], in_trans, generator)
    return twoview_loss(cfg["loss_weights"], body, pose, betas, batch)


def trainable(sd: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The parameters: every float tensor but the BatchNorm statistics and
    the mean-parameter buffers."""
    return {n: v for n, v in sd.items()
            if not n.startswith("init_") and v.is_floating_point()
            and not n.endswith(("running_mean", "running_var"))}
