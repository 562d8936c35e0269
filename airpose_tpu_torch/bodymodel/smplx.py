"""SMPL-X body model: a dataclass of tensors and a pure forward.

Port of airpose_tpu/bodymodel/smplx.py. The 127 output joints are the 55
kinematic joints (J_regressor), 21 vertex-picked extra joints (face, feet,
finger tips) and 51 facial landmarks, in the upstream smplx package order.

Whole-body callers (Multi-HMR) also pose the jaw and both hands and give
expression coefficients, whose blend shapes (``expr_dirs``) add to the
shape's as in the smplx package (``shapedirs`` [:, :, 300:] of the released
files). Without them the forward is the body-only one the AirPose and HMR
families run: hands at the model's mean, jaw and eyes at the identity, no
expression.
"""

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry.rotations import batch_rodrigues
from . import lbs as _lbs

NUM_JOINTS = 55
NUM_HAND_JOINTS = 15
NUM_FACE_LANDMARKS = 51
NUM_EXTRA_JOINTS = 21
NUM_EXPRESSION = 10

# Vertex indices of the extra picked joints, in the upstream smplx order:
# 5 face points, 6 feet points, 10 finger tips.
SMPLX_EXTRA_VERTEX_IDS = (
    9120, 9929, 9448, 616, 6,              # nose, reye, leye, rear, lear
    5770, 5780, 8846, 8463, 8474, 8635,    # LBigToe, LSmallToe, LHeel, RBigToe, RSmallToe, RHeel
    5361, 4933, 5058, 5169, 5286,          # left thumb/index/middle/ring/pinky tips
    8079, 7669, 7794, 7905, 8022,          # right thumb/index/middle/ring/pinky tips
)

# SMPL-X kinematic tree (55 joints): 22 body, jaw, eyes, 15+15 hand joints.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,                                    # jaw, left eye, right eye
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
)


class SMPLXOutput(NamedTuple):
    vertices: torch.Tensor  # (B, V, 3)
    joints: torch.Tensor    # (B, 127, 3)


@dataclasses.dataclass(frozen=True)
class SMPLXParams:
    """Frozen SMPL-X model tensors (all on one device)."""

    v_template: torch.Tensor       # (V, 3)
    shape_dirs: torch.Tensor       # (V, 3, num_betas)
    pose_dirs: torch.Tensor        # ((J-1)*9, V*3)
    j_regressor: torch.Tensor      # (J, V)
    lbs_weights: torch.Tensor      # (V, J)
    hand_pose: torch.Tensor        # (2*NUM_HAND_JOINTS, 3, 3) mean-hand rotmats
    extra_joint_ids: torch.Tensor  # (21,) int64 vertex picks
    lmk_vert_ids: torch.Tensor     # (51, 3) int64 face-triangle vertex ids
    lmk_bary: torch.Tensor         # (51, 3) barycentric weights
    parents: Tuple[int, ...]
    faces: np.ndarray              # (F, 3), host-side
    expr_dirs: Optional[torch.Tensor] = None   # (V, 3, num_expression); None: no expression

    def to(self, device) -> "SMPLXParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def smplx_forward(
    params: SMPLXParams,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    global_orient: torch.Tensor,
    transl: Optional[torch.Tensor] = None,
    pose2rot: bool = False,
    use_kernels: bool = True,
    jaw_pose: Optional[torch.Tensor] = None,
    hand_pose: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,
) -> SMPLXOutput:
    """Pure SMPL-X forward.

    With ``pose2rot=False`` ``body_pose`` is (B, 21, 3, 3) and
    ``global_orient`` (B, 1, 3, 3) or (B, 3, 3); with ``pose2rot=True`` they
    are axis-angle (B, 63) and (B, 3). ``jaw_pose`` (B, 1, 3, 3) and
    ``hand_pose`` (B, 30, 3, 3; left hand first) are rotation matrices;
    left out, the jaw takes the identity and the hands the model's mean
    hand pose. The eyes take the identity. ``expression`` (B, E) weighs the
    model's ``expr_dirs``; left out, there is no expression. Skinning goes
    through the CUDA kernel on the card unless ``use_kernels=False``.
    """
    B = betas.shape[0]
    dtype, device = betas.dtype, betas.device
    jaw_eyes_pose = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3, 3)
    if jaw_pose is not None:
        jaw_eyes_pose = torch.cat([jaw_pose.to(dtype), jaw_eyes_pose[:, 1:]], dim=1)
    if hand_pose is None:
        hand_pose = params.hand_pose.to(dtype).expand((B,) + params.hand_pose.shape)
    shape_dirs = params.shape_dirs.to(dtype)
    if expression is not None:
        if params.expr_dirs is None:
            raise ValueError("smplx_forward: expression given, the model has no expr_dirs")
        betas = torch.cat([betas, expression.to(dtype)], dim=-1)
        shape_dirs = torch.cat([shape_dirs, params.expr_dirs.to(dtype)], dim=-1)

    full_pose = _lbs.full_pose_from_parts(
        global_orient, body_pose, jaw_eyes_pose, hand_pose.to(dtype), pose2rot=pose2rot)
    verts, posed_joints = _lbs.lbs(
        betas,
        full_pose,
        params.v_template.to(dtype),
        shape_dirs,
        params.pose_dirs.to(dtype),
        params.j_regressor.to(dtype),
        params.parents,
        params.lbs_weights.to(dtype),
        use_kernels=use_kernels,
    )

    extra = verts[:, params.extra_joint_ids]   # (B, 21, 3)
    lmk_verts = verts[:, params.lmk_vert_ids]  # (B, 51, 3, 3)
    landmarks = torch.einsum("blvc,lv->blc", lmk_verts, params.lmk_bary.to(dtype))
    joints = torch.cat([posed_joints, extra, landmarks], dim=1)

    if transl is not None:
        verts = verts + transl[:, None]
        joints = joints + transl[:, None]
    return SMPLXOutput(vertices=verts, joints=joints)


def _hand_rotmats(hands_mean: np.ndarray) -> torch.Tensor:
    return batch_rodrigues(torch.from_numpy(hands_mean.reshape(-1, 3)))


def load_smplx_npz(
    path: str,
    gender: str = "neutral",
    num_betas: int = 10,
    flat_hand_mean: bool = False,
    dtype=torch.float32,
) -> SMPLXParams:
    """Load a released SMPLX_{MALE,FEMALE,NEUTRAL}.npz (or the directory
    holding them) into SMPLXParams on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, f"SMPLX_{gender.upper()}.npz")
    data = np.load(path, allow_pickle=True)

    v_template = np.asarray(data["v_template"], dtype=np.float32)
    shapedirs = np.asarray(data["shapedirs"], dtype=np.float32)[:, :, :num_betas]
    posedirs = np.asarray(data["posedirs"], dtype=np.float32)
    # (V, 3, (J-1)*9) → ((J-1)*9, V*3)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T.copy()
    j_regressor = np.asarray(data["J_regressor"], dtype=np.float32)
    weights = np.asarray(data["weights"], dtype=np.float32)
    parents = tuple(int(p) for p in np.asarray(data["kintree_table"])[0])
    parents = (-1,) + parents[1:]
    faces = np.asarray(data["f"], dtype=np.int64)

    if flat_hand_mean:
        hands_mean = np.zeros(2 * NUM_HAND_JOINTS * 3, dtype=np.float32)
    else:
        hands_mean = np.concatenate(
            [np.asarray(data["hands_meanl"]), np.asarray(data["hands_meanr"])]
        ).astype(np.float32)

    lmk_faces_idx = np.asarray(data["lmk_faces_idx"], dtype=np.int64)
    lmk_bary = np.asarray(data["lmk_bary_coords"], dtype=np.float32)
    return smplx_params_from_numpy(
        v_template=v_template, shape_dirs=shapedirs, pose_dirs=posedirs,
        j_regressor=j_regressor, lbs_weights=weights,
        hand_pose=_hand_rotmats(hands_mean),
        extra_joint_ids=np.asarray(SMPLX_EXTRA_VERTEX_IDS),
        lmk_vert_ids=faces[lmk_faces_idx], lmk_bary=lmk_bary,
        parents=parents, faces=faces, dtype=dtype)


def smplx_params_from_numpy(*, v_template, shape_dirs, pose_dirs, j_regressor,
                            lbs_weights, hand_pose, extra_joint_ids,
                            lmk_vert_ids, lmk_bary, parents, faces,
                            expr_dirs=None, dtype=torch.float32) -> SMPLXParams:
    """SMPLXParams on the CPU from arrays named as the JAX SMPLXParams
    fields (e.g. ``smplx_params_from_numpy(**{f: np.asarray(getattr(p, f))
    ...})`` for a JAX ``p``)."""
    def f(a):
        return torch.as_tensor(np.array(a), dtype=dtype)

    def i(a):
        return torch.as_tensor(np.array(a), dtype=torch.int64)

    return SMPLXParams(
        v_template=f(v_template), shape_dirs=f(shape_dirs),
        pose_dirs=f(pose_dirs), j_regressor=f(j_regressor),
        lbs_weights=f(lbs_weights), hand_pose=f(hand_pose),
        extra_joint_ids=i(extra_joint_ids), lmk_vert_ids=i(lmk_vert_ids),
        lmk_bary=f(lmk_bary), parents=tuple(int(p) for p in parents),
        faces=np.asarray(faces, dtype=np.int64),
        expr_dirs=None if expr_dirs is None else f(expr_dirs))


def synthetic_smplx_params(
    num_vertices: int = 10475,
    num_joints: int = NUM_JOINTS,
    seed: int = 0,
    dtype=torch.float32,
) -> SMPLXParams:
    """Deterministic synthetic model with the real schema, on the CPU.

    Draws from ``np.random.default_rng(seed)`` in the order of the JAX
    package's ``synthetic_smplx_params``, so every drawn array equals its
    JAX counterpart; the
    ``NUM_EXPRESSION`` expression directions, which the JAX model lacks, are
    drawn last from the same generator. Not anthropometric: numerical
    plumbing only.
    """
    rng = np.random.default_rng(seed)
    V, J = num_vertices, num_joints
    parents = SMPLX_PARENTS[:J] if J == NUM_JOINTS else tuple(
        [-1] + [max(0, j - 1) for j in range(1, J)]
    )
    v_template = rng.normal(size=(V, 3)).astype(np.float32) * 0.3
    shape_dirs = rng.normal(size=(V, 3, 10)).astype(np.float32) * 0.01
    pose_dirs = (rng.normal(size=((J - 1) * 9, V * 3)) * 0.001).astype(np.float32)
    j_regressor = rng.random(size=(J, V)).astype(np.float32) ** 8
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    w = rng.random(size=(V, J)).astype(np.float32) ** 4
    lbs_weights = w / w.sum(axis=1, keepdims=True)
    hands_mean = (rng.normal(size=(2 * NUM_HAND_JOINTS, 3)) * 0.1).astype(np.float32)
    hand_rotmats = _hand_rotmats(hands_mean)
    if J < NUM_JOINTS:
        hand_rotmats = torch.eye(3).expand(30, 3, 3)
    extra_ids = rng.integers(0, V, size=(NUM_EXTRA_JOINTS,)).astype(np.int32)
    lmk_vert_ids = rng.integers(0, V, size=(NUM_FACE_LANDMARKS, 3)).astype(np.int32)
    lmk_bary = rng.random(size=(NUM_FACE_LANDMARKS, 3)).astype(np.float32)
    lmk_bary /= lmk_bary.sum(axis=1, keepdims=True)
    n_faces = max(V - 2, 1)
    faces = np.stack(
        [np.arange(n_faces), np.arange(1, n_faces + 1), np.arange(2, n_faces + 2)],
        axis=1,
    ).astype(np.int64) % V
    expr_dirs = rng.normal(size=(V, 3, NUM_EXPRESSION)).astype(np.float32) * 0.01

    return smplx_params_from_numpy(
        v_template=v_template, shape_dirs=shape_dirs, pose_dirs=pose_dirs,
        j_regressor=j_regressor, lbs_weights=lbs_weights,
        hand_pose=hand_rotmats, extra_joint_ids=extra_ids,
        lmk_vert_ids=lmk_vert_ids, lmk_bary=lmk_bary, parents=parents,
        faces=faces, expr_dirs=expr_dirs, dtype=dtype)
