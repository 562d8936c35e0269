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


def rotmat_to_quat(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 4) wxyz, branchless Shepperd-style extraction:
    all four candidate quaternions (one per dominant component) are formed
    and the one with the largest squared magnitude is kept; sign w ≥ 0."""
    m = rotmat
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    # four squared magnitudes (times 4): w², x², y², z²
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def half_sqrt(a):
        return torch.sqrt(torch.clamp(a, min=1e-12)) / 2.0

    def candidate(d, comps):
        return torch.stack(comps, dim=-1) / (4.0 * d)[..., None]

    w, x, y, z = half_sqrt(qw2), half_sqrt(qx2), half_sqrt(qy2), half_sqrt(qz2)
    cands = torch.stack([
        candidate(w, [4 * w * w, m21 - m12, m02 - m20, m10 - m01]),
        candidate(x, [m21 - m12, 4 * x * x, m01 + m10, m02 + m20]),
        candidate(y, [m02 - m20, m01 + m10, 4 * y * y, m12 + m21]),
        candidate(z, [m10 - m01, m02 + m20, m12 + m21, 4 * z * z]),
    ], dim=-2)
    idx = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)
    quat = torch.take_along_dim(cands, idx[..., None, None], dim=-2).squeeze(-2)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w0 = quat[..., :1]
    return quat * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))


def rotmat_to_aa(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 3) axis-angle through the quaternion; near the
    identity the scale takes its first-order limit 2."""
    quat = rotmat_to_quat(rotmat)
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    xyz = quat[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-6, torch.full_like(angle, 2.0),
                        angle / torch.clamp(sin_half, min=1e-12))
    return xyz * scale[..., None]
