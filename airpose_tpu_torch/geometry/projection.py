"""Camera projection and rigid-transform utilities, batched (port of
airpose_tpu/geometry/projection.py).

The JAX side runs its products and solves at ``precision="highest"``; here
they run in the inputs' dtype with TF32 off (package-wide).
"""

from typing import Optional, Tuple

import torch


def perspective_projection(points: torch.Tensor, rotation: torch.Tensor,
                           translation: torch.Tensor, focal_length,
                           camera_center: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points through rotation (B, 3, 3) and translation (B, 3)
    to (B, N, 2) pixels. ``focal_length`` is one (fx, fy) for the batch;
    ``camera_center`` is (B, 2), and leading singleton axes are squeezed, as
    the reference's ``unsqueeze(0)``-ed centers need."""
    camera_center = torch.as_tensor(camera_center, dtype=points.dtype, device=points.device)
    while camera_center.ndim > 2:
        camera_center = camera_center.squeeze(0)
    if camera_center.ndim == 1:
        camera_center = camera_center[None]
    focal = torch.as_tensor(focal_length, dtype=points.dtype, device=points.device)
    cam_pts = torch.einsum("bij,bkj->bki", rotation, points) + translation[:, None, :]
    proj = cam_pts / cam_pts[..., -1:]
    return proj[..., :2] * focal[None, None, :2] + camera_center[:, None, :]


def backproject(uv: torch.Tensor, depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixels ``uv`` (..., 2) at ``depth`` (...) through zero-skew intrinsics
    ``intr`` (..., 3, 3) → camera-frame points depth · K⁻¹[u, v, 1] (..., 3)."""
    x = (uv[..., 0] - intr[..., 0, 2]) / intr[..., 0, 0]
    y = (uv[..., 1] - intr[..., 1, 2]) / intr[..., 1, 1]
    return depth[..., None] * torch.stack([x, y, torch.ones_like(x)], dim=-1)


def transform_points(trans_mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, 3, 4) or (B, 4, 4) rigid transforms applied to (B, N, 3) points."""
    return (torch.einsum("bij,bnj->bni", trans_mat[:, :3, :3], points)
            + trans_mat[:, None, :3, 3])


def transform_smpl(trans_mat: torch.Tensor, vertices: Optional[torch.Tensor] = None,
                   joints: Optional[torch.Tensor] = None,
                   orientation: Optional[torch.Tensor] = None,
                   trans: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """A batched rigid transform of any subset of (vertices, joints,
    orientation, trans), each returned as None where not given.
    ``orientation`` is (B, k, 3, 3) or (B, 3, 3) and is only rotated."""
    R, t = trans_mat[:, :3, :3], trans_mat[:, :3, 3]
    out_v = transform_points(trans_mat, vertices) if vertices is not None else None
    out_j = transform_points(trans_mat, joints) if joints is not None else None
    out_o = None
    if orientation is not None:
        eq = "bij,bkjl->bkil" if orientation.ndim == 4 else "bij,bjl->bil"
        out_o = torch.einsum(eq, R, orientation)
    out_t = torch.einsum("bij,bj->bi", R, trans) + t if trans is not None else None
    return out_v, out_j, out_o, out_t


def weak_cam_from_position(intr: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) intrinsics and (B, 3) camera-frame root position → (B, 3)
    weak-perspective camera (sz, sx, sy)."""
    fy, cy = intr[:, 1, 1], intr[:, 1, 2]
    z = position[:, 2].abs()
    return torch.stack([fy / (z * cy), position[:, 0] / z, position[:, 1] / z], dim=1)


def weak_cam_to_trans(intr: torch.Tensor, weak_cam: torch.Tensor) -> torch.Tensor:
    """Inverse of ``weak_cam_from_position``."""
    fy, cy = intr[:, 1, 1], intr[:, 1, 2]
    z = fy / (weak_cam[:, 0] * cy)
    return torch.stack([weak_cam[:, 1] * z, weak_cam[:, 2] * z, z], dim=1)


def lstsq_triangulation(intrinsics: torch.Tensor, extrinsics: torch.Tensor,
                        points_2d: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: intrinsics (C, 3, 3), world → camera extrinsics
    (C, 3, 4) or (C, 4, 4), points_2d (C, 2) → the (3,) world point of least
    normalized algebraic error, by one normal-equation solve."""
    pts_h = torch.cat([points_2d, torch.ones_like(points_2d[..., :1])], dim=-1)
    norm_pts = torch.einsum("cij,cj->ci", torch.linalg.inv(intrinsics), pts_h)
    extr = extrinsics[:, :3, :]
    # per camera: A_c = outer(n_xy, r3) − R[0:2], b_c = t[0:2] − t_z · n_xy
    A = (norm_pts[:, :2, None] * extr[:, 2:3, :3] - extr[:, 0:2, :3]).reshape(-1, 3)
    b = (extr[:, 0:2, 3] - extr[:, 2:3, 3] * norm_pts[:, :2]).reshape(-1)
    return torch.linalg.solve(A.T @ A, A.T @ b)


def estimate_translation(joints_3d: torch.Tensor, joints_2d: torch.Tensor,
                         focal_length: float = 5000.0, img_size: float = 224.0
                         ) -> torch.Tensor:
    """Weighted least-squares camera translation (B, 3) from 3D joints
    (B, N, 3) and 2D joints (B, N, 3) [u, v, conf]: each joint gives the
    rows f·t_x + (c_x − u)·t_z = (u − c_x)·Z − f·X and its y analogue,
    weighted by √conf."""
    f, c = focal_length, img_size / 2.0
    XY, Z = joints_3d[..., :2], joints_3d[..., 2]
    uv = joints_2d[..., :2]
    w = torch.sqrt(torch.clamp(joints_2d[..., 2], min=0.0))  # (B, N)
    zeros = torch.zeros_like(Z)
    fs = torch.full_like(Z, f)
    rows_x = torch.stack([fs, zeros, c - uv[..., 0]], dim=-1)
    rows_y = torch.stack([zeros, fs, c - uv[..., 1]], dim=-1)
    Q = torch.cat([rows_x, rows_y], dim=1)  # (B, 2N, 3)
    rhs = torch.cat([(uv[..., 0] - c) * Z - f * XY[..., 0],
                     (uv[..., 1] - c) * Z - f * XY[..., 1]], dim=1)  # (B, 2N)
    ww = torch.cat([w, w], dim=1)
    Qw, cw = Q * ww[..., None], rhs * ww
    A = torch.einsum("bni,bnj->bij", Qw, Qw)
    b = torch.einsum("bni,bn->bi", Qw, cw)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def weak_cam_crop_to_full_trans(weak_cam: torch.Tensor, bb: torch.Tensor,
                                intr: torch.Tensor, focal, img_res: int = 224
                                ) -> torch.Tensor:
    """An HMR-style crop-frame weak camera (B, 3) (s, tx, ty), the crop's bb
    (B, 3) (center / principal − 1, scale) and full-image intrinsics
    (B, 3, 3) → the full-image camera-frame root translation (B, 3): the
    crop-modified intrinsics applied to the weak translation, then the
    depth rescaled by the crop scale."""
    f = torch.as_tensor(focal, dtype=weak_cam.dtype, device=weak_cam.device)
    cam_t = torch.stack([weak_cam[:, 1], weak_cam[:, 2],
                         2 * f[0] / (img_res * weak_cam[:, 0] + 1e-9)], dim=-1)
    s = bb[:, 2]
    principal = intr[:, :2, 2]
    mx = (f[0] / s) * cam_t[:, 0] + bb[:, 0] * principal[:, 0] * cam_t[:, 2]
    my = (f[1] / s) * cam_t[:, 1] + bb[:, 1] * principal[:, 1] * cam_t[:, 2]
    v = torch.stack([mx / intr[:, 0, 0], my / intr[:, 1, 1], cam_t[:, 2]], dim=-1)
    z = cam_t[:, 2] * s
    return v * (z / v[:, 2])[:, None]
