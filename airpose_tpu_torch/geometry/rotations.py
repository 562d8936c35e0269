"""Rotation representation conversions, fully batched over leading dims.

Port of airpose_tpu/geometry/rotations.py with the same numerical
contracts: ``batch_rodrigues`` adds the reference's elementwise +1e-8
inside the norm, ``rot6d_to_rotmat`` reads the 6 numbers column-major as a
(3, 2) matrix and normalizes with max(‖v‖, eps) semantics.
"""

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis: v / max(‖v‖, eps)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion → (..., 3, 3) rotation matrix."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3) rotation matrix, through the
    quaternion, with the +1e-8 regularizer added before the norm."""
    angle = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    axis = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous 6D rotation → (..., 3, 3): the 6 numbers are the
    first two columns, column-major; returns [b1 b2 b1×b2] as columns."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 6): first two columns, column-major flatten."""
    return rotmat[..., :, :2].reshape(rotmat.shape[:-2] + (6,))
