"""Synthetic two-view dataset (port of airpose_tpu/data/synthetic.py:41-149):
geometrically consistent samples generated from an SMPL-X model.

A body with random shape, pose and world pose is seen by two cameras; the
ground truth follows the JAX package's conventions, those of the reference
AerialPeople loader:

  * bb = (crop_center / principal_point − 1, crop_scale)
  * crop 2D coords = scale · (full_coords − crop_center)
  * GT canonical mesh at identity root and zero translation
  * per-view root orient/trans = camera rotation ∘ world pose

Images are joint-blob renderings (one Gaussian per body joint in crop
coordinates). The draws come from a ``torch.Generator`` seeded with
``seed``, so they differ from the JAX package's; the conventions do not.
"""

from typing import Dict

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device
from ..bodymodel.smplx import SMPLXParams, smplx_forward
from ..geometry.rotations import batch_rodrigues


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(angle), torch.ones_like(angle)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


@torch.no_grad()
def make_synthetic_dataset(smplx_params: SMPLXParams, num_samples: int, seed: int = 0,
                           img_size: int = C.CROP_SIZE, cam_distance: float = 8.0,
                           blob_sigma: float = 4.0) -> Dict[str, torch.Tensor]:
    """A dict of f32 tensors in the canonical batch layout, on the device of
    ``smplx_params``: images (N, 2, S, S, 3), bb (N, 2, 3), intr
    (N, 2, 3, 3), extr (N, 2, 3, 4), gt_trans (N, 2, 3), gt_orient
    (N, 2, 3, 3), gt_pose_rotmat (N, 21, 3, 3), gt_betas (N, 10),
    gt_vertices (N, V, 3), gt_joints (N, 127, 3), gt_j2d and gt_j2d_crop
    (N, 2, 22, 2)."""
    dev = smplx_params.v_template.device
    g = torch.Generator(device=dev).manual_seed(seed)
    N = num_samples

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)

    betas = normal(N, 10) * 0.5
    pose_rotmat = batch_rodrigues(normal(N, 21, 3) * 0.2)
    orient_w = batch_rodrigues(normal(N, 3) * 0.5)
    trans_w = normal(N, 3) * torch.tensor([1.0, 0.5, 1.0], device=dev)

    # canonical (identity-root) body: the GT frame of the 3D losses
    eye = torch.eye(3, device=dev).expand(N, 1, 3, 3)
    canon = smplx_forward(smplx_params, betas, body_pose=pose_rotmat, global_orient=eye)

    # two cameras: distinct yaws, the person ~cam_distance in front
    angles = torch.stack([uniform(-0.4, 0.0, N), uniform(0.3, 0.7, N)], dim=1)
    R_cam = _rot_y(angles)  # (N, 2, 3, 3)
    t_cam = torch.tensor([0.0, 0.0, cam_distance], device=dev).expand(N, 2, 3)
    extr = torch.cat([R_cam, t_cam[..., None]], dim=-1)

    fx, fy = C.FOCAL_LENGTH
    intr = torch.tensor([[fx, 0, C.CX], [0, fy, C.CY], [0, 0, 1.0]],
                        device=dev).expand(N, 2, 3, 3)

    # per-view GT root pose
    orient_rel = torch.einsum("nvij,njk->nvik", R_cam, orient_w)
    trans_rel = torch.einsum("nvij,nj->nvi", R_cam, trans_w) + t_cam

    # per-view camera-frame joints and full-image 2D
    cam_joints = (torch.einsum("nvij,nkj->nvki", orient_rel, canon.joints[:, :22])
                  + trans_rel[:, :, None, :])
    xy = cam_joints[..., :2] / cam_joints[..., 2:]
    j2d_full = (xy * torch.tensor([fx, fy], device=dev)
                + torch.tensor([C.CX, C.CY], device=dev))  # (N, 2, 22, 2)

    # crop window from the joints' bbox ± 50 px, clamped to the frame
    frame = torch.tensor(C.IMG_SIZE, dtype=torch.float32, device=dev)
    mins = torch.clamp(j2d_full.amin(dim=2) - 50.0, min=torch.zeros_like(frame), max=frame)
    maxs = torch.clamp(j2d_full.amax(dim=2) + 50.0, min=torch.zeros_like(frame), max=frame)
    center = (mins + maxs) / 2.0  # (N, 2, 2)
    extent = torch.clamp(maxs - mins, min=1.0)
    scale = img_size / extent.amax(dim=-1)  # (N, 2)

    bb = torch.cat([center / torch.tensor([C.CX, C.CY], device=dev) - 1.0,
                    scale[..., None]], dim=-1)
    j2d_crop = scale[..., None, None] * (j2d_full - center[:, :, None, :])

    # blob images at crop coords (+img_size/2 to pixel space)
    blob_xy = j2d_crop + img_size / 2.0
    ii = torch.arange(img_size, dtype=torch.float32, device=dev)
    gy = torch.exp(-((ii[None, None, :, None] - blob_xy[..., 1][:, :, None, :]) ** 2)
                   / (2 * blob_sigma ** 2))  # (N, 2, H, 22)
    gx = torch.exp(-((ii[None, None, :, None] - blob_xy[..., 0][:, :, None, :]) ** 2)
                   / (2 * blob_sigma ** 2))  # (N, 2, W, 22)
    img = torch.clamp(torch.einsum("nvhk,nvwk->nvhw", gy, gx), 0.0, 1.0)
    mean = torch.tensor(C.IMG_NORM_MEAN, device=dev)
    std = torch.tensor(C.IMG_NORM_STD, device=dev)
    images = (img[..., None] - mean) / std

    data = {
        "images": images, "bb": bb, "intr": intr, "extr": extr,
        "gt_trans": trans_rel, "gt_orient": orient_rel, "gt_pose_rotmat": pose_rotmat,
        "gt_betas": betas, "gt_vertices": canon.vertices, "gt_joints": canon.joints,
        "gt_j2d": j2d_full, "gt_j2d_crop": j2d_crop,
    }
    return {k: v.float().contiguous() for k, v in data.items()}


def batch_slice(data: Dict[str, torch.Tensor], start: int, size: int,
                device=None) -> Dict[str, torch.Tensor]:
    """Rows ``start:start + size`` of every array, as tensors on ``device``
    (CUDA by default; raises without it). Numpy arrays (e.g. the JAX
    package's dataset) are taken as well."""
    dev = resolve_device(device)
    return {k: (v[start:start + size] if torch.is_tensor(v)
                else torch.from_numpy(np.array(v[start:start + size]))).to(dev)
            for k, v in data.items()}
