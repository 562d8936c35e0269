"""Plain SMPL-X forward and rotations (float32, no kernels).

  v_shaped = v_template + shape_dirs · β
  J        = J_regressor · v_shaped
  v_posed  = v_shaped + pose_dirs · vec(R_1..R_54 − I)
  A_j      = ∏ over the ancestors of j of [R_k | t_k]     (relative to the rest pose)
  v        = Σ_j w_vj A_j · [v_posed; 1]                  (an einsum pair)

The 127 joints are the 55 kinematic joints, 21 vertex picks and 51 facial
landmarks (barycentric over three vertices), as in the smplx package. Hands
take the model's mean hand pose, jaw and eyes the identity.
"""

from typing import Dict, Tuple

import torch

# SMPL-X kinematic tree (55 joints): 22 body joints, jaw, two eyes, 15 + 15
# hand joints.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) → (..., 3, 3): the 6 numbers are the first two columns read
    column-major from a (3, 2) matrix, Gram-Schmidt, the third their cross."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    b1 = normalize(m[..., 0])
    a2 = m[..., 1]
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3), through the unit quaternion, with
    +1e-8 inside the norm."""
    angle = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    axis = theta / angle
    q = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2) * axis], dim=-1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        w * w + x * x - y * y - z * z, 2 * x * y - 2 * w * z, 2 * w * y + 2 * x * z,
        2 * w * z + 2 * x * y, w * w - x * x + y * y - z * z, 2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z, w * w - x * x - y * y + z * z,
    ], dim=-1)
    return rot.reshape(theta.shape[:-1] + (3, 3))


def _levels(parents):
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return [([j for j in range(len(parents)) if depth[j] == d],
             [parents[j] for j in range(len(parents)) if depth[j] == d])
            for d in range(1, max(depth) + 1)]


def forward(p: Dict[str, torch.Tensor], betas: torch.Tensor, body_pose: torch.Tensor,
            global_orient: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """betas (B, 10), body_pose (B, 21, 3, 3), global_orient (B, 1, 3, 3) →
    (vertices (B, V, 3), joints (B, 127, 3)), float32."""
    B = betas.shape[0]
    dev, dt = betas.device, betas.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    rot = torch.cat([global_orient, body_pose, eye.expand(B, 3, 3, 3),
                     p["hand_pose"].expand(B, 30, 3, 3)], dim=1)       # (B, 55, 3, 3)
    v_shaped = p["v_template"][None] + torch.einsum("bs,vcs->bvc", betas, p["shape_dirs"])
    j_rest = torch.einsum("jv,bvc->bjc", p["j_regressor"], v_shaped)
    feat = (rot[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + (feat @ p["pose_dirs"]).reshape(B, -1, 3)

    parents = SMPLX_PARENTS
    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, list(parents[1:])]], dim=1)
    local = torch.cat([torch.cat([rot, rel[..., None]], dim=-1),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=dev
                                    ).expand(B, 55, 1, 4)], dim=-2)
    world = local.clone()
    for js, ps in _levels(parents):
        world[:, js] = world[:, ps] @ local[:, js]
    posed_joints = world[..., :3, 3]
    tf = world.clone()
    tf[..., :3, 3] -= torch.einsum("bjik,bjk->bji", world[..., :3, :3], j_rest)

    T = torch.einsum("vj,bjk->bvk", p["lbs_weights"], tf.reshape(B, 55, 16)).reshape(B, -1, 4, 4)
    verts = torch.einsum("bvij,bvj->bvi", T[..., :3, :3], v_posed) + T[..., :3, 3]

    extra = verts[:, p["extra_joint_ids"]]
    lmk = torch.einsum("blvc,lv->blc", verts[:, p["lmk_vert_ids"]], p["lmk_bary"])
    return verts, torch.cat([posed_joints, extra, lmk], dim=1)
