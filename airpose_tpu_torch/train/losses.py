"""The projection of the perception chain (port of
airpose_tpu/train/losses.py::cam_frame_and_project). The losses themselves
are not ported yet."""

import torch


def cam_frame_and_project(rotmat_root, trans, joints, intr, focal):
    """Rotate canonical joints by the root, translate, project.

    rotmat_root (B, V, 3, 3), trans (B, V, 3), joints (B, V, N, 3),
    intr (B, V, 3, 3) → (cam_joints (B, V, N, 3), j2d (B, V, N, 2)).
    ``focal`` is one (fx, fy) pair, per-view (V, 2) or per-sample (B, V, 2);
    the principal point comes from ``intr``.
    """
    cam_j = (torch.einsum("bvij,bvnj->bvni", rotmat_root, joints)
             + trans[:, :, None, :])
    xy = cam_j[..., :2] / cam_j[..., 2:]
    f = torch.as_tensor(focal, dtype=xy.dtype, device=xy.device)
    if f.ndim == 2:  # per-view (V, 2) focal lengths (real DJI cameras)
        f = f[None, :, None, :]
    elif f.ndim == 3:  # per-sample per-view (B, V, 2): dataset intrinsics
        f = f[:, :, None, :]
    center = intr[..., :2, 2]
    return cam_j, xy * f + center[:, :, None, :]
