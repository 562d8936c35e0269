"""The benchmark's inputs, made on the device from the seed.

Two generators, each read by the drivers with the parameters of a traffic
file (``benchmark/traffic/<traffic>.json``):

* ``perception_pool``: distinct batches of two-view frames as the
  perception chain takes them: normalised crops (B, 2, S, S, 3), each a
  smooth random field (a 7 × 7 normal field per channel, upsampled) plus
  half as much pixel noise, at a random brightness per channel and contrast
  per crop, so that no two crops look alike; crop boxes ``bb`` (B, 2, 3),
  the IEF translation start (B, 2, 3), the synthetic camera (B, 2, 3, 3).
* ``training_pool``: distinct batches of the synthetic two-view training
  set: a body of random shape and pose, its canonical SMPL-X vertices and
  joints from the plain reference (``reference/smplx.py``), seen by two
  cameras of different yaw about 8 m away, rendered as one Gaussian blob per
  body joint in crop coordinates and normalised with ImageNet's mean and
  deviation; the ground truth follows the AerialPeople loader's conventions
  (bb = (crop centre / principal point − 1, crop scale), crop coordinates =
  scale · (image coordinates − crop centre), per-view root pose = camera
  rotation ∘ world pose).
"""

from typing import Dict, List, Mapping

import torch
from torch.nn import functional as F

from .reference import smplx
from .reference.model import FOCAL, TRANS_SCALE

IMAGE_SIZE = (1920.0, 1080.0)          # the synthetic camera's frame (W, H)
CENTER = (IMAGE_SIZE[0] / 2, IMAGE_SIZE[1] / 2)
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


def intrinsics(n: int, device) -> torch.Tensor:
    k = torch.tensor([[FOCAL[0], 0.0, CENTER[0]], [0.0, FOCAL[1], CENTER[1]], [0.0, 0.0, 1.0]],
                     device=device)
    return k.expand(n, 2, 3, 3)


def perception_pool(seed: int, batches: int, batch: int, crop: int, device) -> List[Dict]:
    """``batches`` distinct perception batches, each a dict of images, bb,
    init_position and intr."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = batches * batch
    coarse = torch.randn((n * 2, 3, 7, 7), generator=g, device=device)
    field = F.interpolate(coarse, size=(crop, crop), mode="bilinear", align_corners=False)
    field = field.permute(0, 2, 3, 1).reshape(batches, batch, 2, crop, crop, 3)
    noise = torch.randn((batches, batch, 2, crop, crop, 3), generator=g, device=device)
    brightness = torch.randn((batches, batch, 2, 1, 1, 3), generator=g, device=device)
    contrast = 0.5 + torch.rand((batches, batch, 2, 1, 1, 1), generator=g, device=device)
    images = brightness + contrast * (field + 0.5 * noise)
    del coarse, field, noise
    bb = torch.cat([0.1 * torch.randn((n, 2, 2), generator=g, device=device),
                    0.3 + 0.4 * torch.rand((n, 2, 1), generator=g, device=device)], dim=-1)
    pos = torch.cat([0.3 * torch.randn((n, 2, 2), generator=g, device=device),
                     8.0 + 4.0 * torch.rand((n, 2, 1), generator=g, device=device)], dim=-1)
    pos = pos * TRANS_SCALE
    intr = intrinsics(batch, device)
    return [{"images": images[i], "bb": bb[i * batch:(i + 1) * batch],
             "init_position": pos[i * batch:(i + 1) * batch], "intr": intr}
            for i in range(batches)]


def _rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


@torch.no_grad()
def training_pool(seed: int, body: Mapping[str, torch.Tensor], batches: int, batch: int,
                  crop: int, device, cam_distance: float = 8.0,
                  blob_sigma: float = 4.0) -> List[Dict[str, torch.Tensor]]:
    """``batches`` distinct batches of ``batch`` synthetic two-view samples."""
    g = torch.Generator(device=device).manual_seed(seed)
    N = batches * batch

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(N, generator=g, device=device)

    betas = normal(N, 10) * 0.5
    pose = smplx.batch_rodrigues(normal(N, 21, 3) * 0.2)
    orient_w = smplx.batch_rodrigues(normal(N, 3) * 0.5)
    trans_w = normal(N, 3) * torch.tensor([1.0, 0.5, 1.0], device=device)
    eye = torch.eye(3, device=device).expand(N, 1, 3, 3)
    verts, joints = smplx.forward(body, betas, pose, eye)

    R = _rot_y(torch.stack([uniform(-0.4, 0.0), uniform(0.3, 0.7)], dim=1))   # (N, 2, 3, 3)
    t_cam = torch.tensor([0.0, 0.0, cam_distance], device=device)
    orient = torch.einsum("nvij,njk->nvik", R, orient_w)
    trans = torch.einsum("nvij,nj->nvi", R, trans_w) + t_cam
    cam_j = torch.einsum("nvij,nkj->nvki", orient, joints[:, :22]) + trans[:, :, None]
    j2d = (cam_j[..., :2] / cam_j[..., 2:] * torch.tensor(FOCAL, device=device)
           + torch.tensor(CENTER, device=device))

    frame = torch.tensor(IMAGE_SIZE, device=device)
    lo = torch.minimum(torch.clamp(j2d.amin(dim=2) - 50.0, min=0.0), frame)
    hi = torch.minimum(torch.clamp(j2d.amax(dim=2) + 50.0, min=0.0), frame)
    center = (lo + hi) / 2.0
    scale = crop / torch.clamp(hi - lo, min=1.0).amax(dim=-1)
    bb = torch.cat([center / torch.tensor(CENTER, device=device) - 1.0, scale[..., None]], -1)
    j2d_crop = scale[..., None, None] * (j2d - center[:, :, None])

    blob = j2d_crop + crop / 2.0
    ii = torch.arange(crop, dtype=torch.float32, device=device)
    gy = torch.exp(-((ii[None, None, :, None] - blob[..., 1][:, :, None]) ** 2) / (2 * blob_sigma ** 2))
    gx = torch.exp(-((ii[None, None, :, None] - blob[..., 0][:, :, None]) ** 2) / (2 * blob_sigma ** 2))
    img = torch.clamp(torch.einsum("nvhk,nvwk->nvhw", gy, gx), 0.0, 1.0)
    images = (img[..., None] - torch.tensor(IMG_MEAN, device=device)) / torch.tensor(
        IMG_STD, device=device)

    data = {"images": images, "bb": bb, "intr": intrinsics(N, device), "gt_trans": trans,
            "gt_orient": orient, "gt_pose_rotmat": pose, "gt_betas": betas,
            "gt_vertices": verts, "gt_joints": joints, "gt_j2d": j2d, "gt_j2d_crop": j2d_crop}
    data = {k: v.float().contiguous() for k, v in data.items()}
    return [{k: v[i * batch:(i + 1) * batch] for k, v in data.items()} for i in range(batches)]
