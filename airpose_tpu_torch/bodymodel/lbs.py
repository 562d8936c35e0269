"""Linear blend skinning core, batched (port of airpose_tpu/bodymodel/lbs.py).

  v_shaped  = v_template + shapedirs · β
  J         = J_regressor · v_shaped
  v_posed   = v_shaped + posedirs · vec(R_1..R_{J-1} − I)
  A_j       = ∏_{k∈ancestors(j)} T_k            (rigid chain)
  v_out     = Σ_j w_vj A_j · v_posed            (skinning, cuda_lbs.py)

The package turns TF32 off, so every f32 product here is full f32, as the
JAX side's precision="highest".
"""

import functools
from typing import Sequence, Tuple

import torch

from .. import device_constant
from ..geometry.rotations import batch_rodrigues
from .cuda_lbs import skinning, skinning_reference


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor) -> torch.Tensor:
    """(B, S) coefficients × (V, 3, S) dirs → (B, V, 3) offsets."""
    return torch.einsum("bs,vcs->bvc", betas, shape_dirs)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) regressor × (B, V, 3) → (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", j_regressor, vertices)


def pose_blend_offsets(rotmats: torch.Tensor, pose_dirs: torch.Tensor) -> torch.Tensor:
    """Pose-corrective offsets (B, V, 3) from (B, J, 3, 3) full-pose
    rotations (the root adds no feature) and the ((J-1)·9, V·3) basis."""
    B = rotmats.shape[0]
    ident = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    feat = (rotmats[:, 1:] - ident).reshape(B, -1)
    return torch.matmul(feat, pose_dirs).reshape(B, -1, 3)


@functools.lru_cache(maxsize=None)
def _tree_levels(parents: Tuple[int, ...]) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """Joints grouped by depth in the tree, each level as (joints, their
    parents): one batched product per level instead of one per joint."""
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, max(depth, default=0) + 1):
        js = tuple(j for j in range(len(parents)) if depth[j] == d)
        levels.append((js, tuple(parents[j] for j in js)))
    return tuple(levels)


def batch_rigid_transform(
    rotmats: torch.Tensor, joints: torch.Tensor, parents: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose per-joint rotations along the kinematic tree.

    rotmats (B, J, 3, 3), joints (B, J, 3) rest-pose locations, parents the
    static parent table (parents[0] is the root) → posed joints (B, J, 3)
    and skinning transforms relative to the rest pose (B, J, 4, 4).
    """
    B, J = joints.shape[:2]
    dev = joints.device
    parents = tuple(int(p) for p in parents)
    rel = torch.cat(
        [joints[:, :1], joints[:, 1:] - joints[:, device_constant(parents[1:], torch.int64, dev)]],
        dim=1)

    top = torch.cat([rotmats, rel[..., None]], dim=-1)  # (B, J, 3, 4)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), top.dtype, dev).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=-2)  # (B, J, 4, 4)

    world = local.clone()
    for js, ps in _tree_levels(parents):
        js, ps = (device_constant(t, torch.int64, dev) for t in (js, ps))
        world[:, js] = torch.matmul(world[:, ps], local[:, js])
    posed_joints = world[..., :3, 3]

    # Relative-to-rest correction: A = G · [I | -j_rest].
    correction = torch.einsum("bjJK,bjK->bjJ", world[..., :3, :3], joints)
    rel_tf = world.clone()
    rel_tf[..., :3, 3] -= correction
    return posed_joints, rel_tf


def lbs(
    betas: torch.Tensor,
    full_pose_rotmats: torch.Tensor,
    v_template: torch.Tensor,
    shape_dirs: torch.Tensor,
    pose_dirs: torch.Tensor,
    j_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full LBS pipeline → (vertices (B, V, 3), joints (B, J, 3)). With
    ``use_kernels=False`` the skinning runs its plain version on any device
    (the oracle the on-card check compares against)."""
    v_shaped = v_template[None] + blend_shapes(betas, shape_dirs)
    joints_rest = vertices2joints(j_regressor, v_shaped)
    v_posed = v_shaped + pose_blend_offsets(full_pose_rotmats, pose_dirs)
    posed_joints, rel_tf = batch_rigid_transform(
        full_pose_rotmats, joints_rest, parents)
    skin = skinning if use_kernels else skinning_reference
    verts = skin(lbs_weights.contiguous(), rel_tf.contiguous(),
                 v_posed.contiguous())
    return verts, posed_joints


def full_pose_from_parts(
    global_orient: torch.Tensor,
    body_pose: torch.Tensor,
    jaw_eyes_pose: torch.Tensor,
    hand_pose: torch.Tensor,
    pose2rot: bool,
) -> torch.Tensor:
    """The 55-joint SMPL-X full pose (B, 55, 3, 3) from its named parts.
    With ``pose2rot`` the body parts are axis-angle and converted; jaw/eyes
    and hands arrive as (B, k, 3, 3) rotmats."""
    if pose2rot:
        B = body_pose.shape[0]
        global_orient = batch_rodrigues(global_orient.reshape(B, 1, 3))
        body_pose = batch_rodrigues(body_pose.reshape(B, -1, 3))
    elif global_orient.ndim == 3:
        global_orient = global_orient[:, None]
    return torch.cat([global_orient, body_pose, jaw_eyes_pose, hand_pose], dim=1)
