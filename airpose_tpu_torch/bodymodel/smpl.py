"""SMPL body model (Loper et al., SIGGRAPH Asia 2015), as ``smplx.SMPL``
computes it: 6,890 vertices, 24 joints, 10 betas, 207 pose blend shapes,
through the same ``lbs`` functions and skinning kernel as SMPL-X.

The 45 output joints are the 24 kinematic joints and 21 picked from
vertices by the smplx package's ``vertex_ids['smplh']``: 5 face points, 6
feet points, the left then the right hand's 5 finger tips.
"""

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import lbs as _lbs

NUM_JOINTS = 24
NUM_VERTICES = 6890

# SMPL's kinematic tree: 22 body joints as in SMPL-X, then the two hands on
# the wrists (SMPL-X puts the jaw and eyes there).
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                20, 21)

# vertex_ids['smplh'] in the order of smplx's VertexJointSelector: nose, reye,
# leye, rear, lear; LBigToe, LSmallToe, LHeel, RBigToe, RSmallToe, RHeel; the
# left thumb, index, middle, ring, pinky tips; the right ones.
SMPL_EXTRA_VERTEX_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
                         2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133)


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor  # (B, V, 3)
    joints: torch.Tensor    # (B, 45, 3)


@dataclasses.dataclass(frozen=True)
class SMPLParams:
    """Frozen SMPL model tensors (all on one device)."""

    v_template: torch.Tensor       # (V, 3)
    shape_dirs: torch.Tensor       # (V, 3, num_betas)
    pose_dirs: torch.Tensor        # (23·9, V·3)
    j_regressor: torch.Tensor      # (24, V)
    lbs_weights: torch.Tensor      # (V, 24)
    extra_joint_ids: torch.Tensor  # (21,) int64 vertex picks
    parents: Tuple[int, ...] = SMPL_PARENTS

    def to(self, device) -> "SMPLParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def smpl_forward(params: SMPLParams, betas: torch.Tensor, body_pose: torch.Tensor,
                 global_orient: torch.Tensor) -> SMPLOutput:
    """betas (B, 10), body_pose (B, 23, 3, 3), global_orient (B, 1, 3, 3)
    → vertices (B, V, 3) and joints (B, 45, 3), before any translation.
    Skinning goes through the CUDA kernel for tensors on the card."""
    dtype = betas.dtype
    full_pose = torch.cat([global_orient, body_pose], dim=1)
    verts, posed_joints = _lbs.lbs(
        betas, full_pose, params.v_template.to(dtype), params.shape_dirs.to(dtype),
        params.pose_dirs.to(dtype), params.j_regressor.to(dtype), params.parents,
        params.lbs_weights.to(dtype))
    joints = torch.cat([posed_joints, verts[:, params.extra_joint_ids]], dim=1)
    return SMPLOutput(vertices=verts, joints=joints)


def synthetic_smpl_params(num_vertices: int = NUM_VERTICES, seed: int = 0,
                          dtype=torch.float32) -> SMPLParams:
    """A deterministic synthetic model with SMPL's schema, on the CPU: the
    licensed model files are not in the repository. Not anthropometric. At
    6,890 vertices the extra joints are the published vertex picks, at any
    other size picks drawn from the seed."""
    rng = np.random.default_rng(seed)
    V, J = num_vertices, NUM_JOINTS
    v_template = rng.normal(size=(V, 3)) * 0.3
    shape_dirs = rng.normal(size=(V, 3, 10)) * 0.01
    pose_dirs = rng.normal(size=((J - 1) * 9, V * 3)) * 0.001
    j_regressor = rng.random(size=(J, V)) ** 8
    w = rng.random(size=(V, J)) ** 4
    extra = (SMPL_EXTRA_VERTEX_IDS if V == NUM_VERTICES
             else rng.integers(0, V, size=len(SMPL_EXTRA_VERTEX_IDS)))

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), dtype=dtype)

    return SMPLParams(
        v_template=f(v_template), shape_dirs=f(shape_dirs), pose_dirs=f(pose_dirs),
        j_regressor=f(j_regressor / j_regressor.sum(axis=1, keepdims=True)),
        lbs_weights=f(w / w.sum(axis=1, keepdims=True)),
        extra_joint_ids=torch.as_tensor(np.asarray(extra), dtype=torch.int64))
