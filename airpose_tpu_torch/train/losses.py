"""Losses of the model families (port of airpose_tpu/train/losses.py).

Each loss is a pure function of the predictions, a batch dict of tensors in
the canonical layout (data/synthetic.py) and the SMPL-X model, term for
term as the JAX package's, with the weights of ``config.LossWeights``; the
self-supervised real-data losses take ``config.RealLossWeights``, the
VPoser prior and a generator for its latent sample. Both
views' SMPL-X forwards run as one folded call, skinned by the CUDA kernel on
the card (differentiable, bodymodel/cuda_lbs.py).
"""

from typing import Dict, Optional, Tuple

import torch

from .. import constants as C
from ..bodymodel.smplx import SMPLXParams, smplx_forward
from ..bodymodel.vposer import VPoserParams, vposer_encode, vposer_rsample
from ..config import LossWeights, RealLossWeights
from ..data.joints import SMPLX_TO_H36M17
from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
from ..parallel.mesh import active_group, all_reduce_sum

Metrics = Dict[str, torch.Tensor]


def _limb_weights(n: int, l1, l2, w: float, like: torch.Tensor) -> torch.Tensor:
    """(n,) factors: w on ``l1``, w² on ``l2``, 1 elsewhere."""
    f = torch.ones(n, dtype=like.dtype, device=like.device)
    f[list(l1)] = w
    f[list(l2)] = w ** 2
    return f


def _limb_weight_joints(sq: torch.Tensor, w: float) -> torch.Tensor:
    """Limb up-weighting on the joint axis of a (..., 22, k) tensor."""
    return sq * _limb_weights(sq.shape[-2], C.LIMB_JOINTS_3D_L1, C.LIMB_JOINTS_3D_L2,
                              w, sq)[:, None]


def _limb_weight_rotmats(sq: torch.Tensor, w: float) -> torch.Tensor:
    """(..., 21, 3, 3) limb weighting."""
    return sq * _limb_weights(sq.shape[-3], C.LIMB_ROTMAT_L1, C.LIMB_ROTMAT_L2,
                              w, sq)[:, None, None]


def _sq(a, b):
    return (a - b) ** 2


def _row_mean(t: torch.Tensor, rw: Optional[torch.Tensor]) -> torch.Tensor:
    """Batch mean of ``t`` (batch on the leading axis). With ``rw=None`` this
    is ``t.mean()``; with a (B,) row weight it is the weighted mean of the
    per-row means, so an eval batch padded to a static size with 1/0 weights
    reports the loss of its valid rows only. Under ``parallel.data_parallel``
    the denominator is the global row-weight sum over the data group, and the
    result this rank's weighted sum times the group's size over it: the
    ranks' mean is the global batch's weighted mean (shards can hold
    different weight sums, so local means would not average to it)."""
    if rw is None:
        return t.mean()
    m = t.reshape(t.shape[0], -1).mean(dim=1)
    group = active_group()
    if group is None:
        return (m * rw).sum() / rw.sum().clamp(min=1.0)
    world = torch.distributed.get_world_size(group)
    return (m * rw).sum() * world / all_reduce_sum(rw.sum(), group).clamp(min=1.0)


def _identity_roots(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(n, 1, 3, 3)


def canonical_smplx_two_view(smplx_params: SMPLXParams, betas: torch.Tensor,
                             rotmat: torch.Tensor, use_kernels: bool = True):
    """SMPL-X forward for both views in one folded call.

    betas (B, 2, 10), rotmat (B, 2, 22, 3, 3) → canonical (identity-root,
    zero-transl) vertices (B, 2, V, 3) and joints (B, 2, 127, 3), the frame
    of the 3D losses."""
    B, V = betas.shape[:2]
    out = smplx_forward(smplx_params, betas.reshape(B * V, -1),
                        body_pose=rotmat[:, :, 1:].reshape(B * V, 21, 3, 3),
                        global_orient=_identity_roots(B * V, betas),
                        use_kernels=use_kernels)
    return out.vertices.reshape(B, V, -1, 3), out.joints.reshape(B, V, -1, 3)


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


def _betas_twoview(pred_betas):
    return ((pred_betas[:, 0] ** 2).mean() + (pred_betas[:, 1] ** 2).mean()
            + _sq(pred_betas[:, 0], pred_betas[:, 1]).mean())


def twoview_loss(pred_pose: torch.Tensor, pred_betas: torch.Tensor,
                 batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams,
                 w: LossWeights, trans_scale: float = C.TRANS_SCALE,
                 vertex_mask: Optional[torch.Tensor] = None,
                 use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """The synthetic two-view supervised loss. pred_pose (B, 2, 135)
    [trans·scale | 6D×22], pred_betas (B, 2, 10); ``vertex_mask`` (V,)
    zeroes hands/face on prediction and GT. ``use_kernels=False`` skins
    with the plain version on any device."""
    B = pred_pose.shape[0]
    trans = pred_pose[..., :3] / trans_scale
    rotmat = rot6d_to_rotmat(pred_pose[..., 3:].reshape(B, 2, 22, 6))

    verts, joints = canonical_smplx_two_view(smplx_params, pred_betas, rotmat, use_kernels)
    _, j2d = cam_frame_and_project(rotmat[:, :, 0], trans, joints, batch["intr"],
                                   C.FOCAL_LENGTH)

    gt_j2d = batch["gt_j2d"]          # (B, 2, 22, 2) full-image coords
    gt_joints = batch["gt_joints"]    # (B, N>=22, 3) canonical
    gt_verts = batch["gt_vertices"]   # (B, V, 3)
    gt_pose = batch["gt_pose_rotmat"]  # (B, 21, 3, 3)
    gt_orient = batch["gt_orient"]    # (B, 2, 3, 3)
    gt_trans = batch["gt_trans"]      # (B, 2, 3)

    loss_kp2d = (_sq(j2d[:, 0, :22], gt_j2d[:, 0, :22]).mean()
                 + _sq(j2d[:, 1, :22], gt_j2d[:, 1, :22]).mean())

    j22 = joints[:, :, :22]
    e3d = (_sq(j22[:, 0], gt_joints[:, :22]) + _sq(j22[:, 1], gt_joints[:, :22])
           + _sq(j22[:, 0], j22[:, 1]))
    loss_kp3d = _limb_weight_joints(e3d, w.limbs3d).mean()

    if vertex_mask is not None:  # hands/face zeroed on pred AND GT
        verts = verts * vertex_mask[:, None]
        gt_verts = gt_verts * vertex_mask[:, None]
    loss_shape = (_sq(verts[:, 0], gt_verts).mean() + _sq(verts[:, 1], gt_verts).mean()
                  + _sq(verts[:, 0], verts[:, 1]).mean())

    loss_trans = _sq(trans, gt_trans).mean(dim=(0, 2)).sum()
    loss_rootrot = (_sq(rotmat[:, 0, 0], gt_orient[:, 0]).mean()
                    + _sq(rotmat[:, 1, 0], gt_orient[:, 1]).mean())
    epose = (_sq(rotmat[:, 0, 1:], gt_pose) + _sq(rotmat[:, 1, 1:], gt_pose)
             + _sq(rotmat[:, 0, 1:], rotmat[:, 1, 1:]))
    loss_pose = _limb_weight_rotmats(epose, w.limbstheta).mean()
    loss_betas = _betas_twoview(pred_betas)

    total = w.total_scale * (
        w.trans * loss_trans + w.keypoint2d * loss_kp2d + w.keypoint3d * loss_kp3d
        + w.shape * loss_shape + w.rootrot * loss_rootrot + w.pose * loss_pose
        + w.beta * loss_betas)
    return total, {
        "loss": total,
        "loss_regr_trans": loss_trans,
        "loss_keypoints": loss_kp2d,
        "loss_keypoints_3d": loss_kp3d,
        "loss_regr_shape": loss_shape,
        "loss_rootrot": loss_rootrot,
        "loss_regr_pose": loss_pose,
        "loss_regul_betas": loss_betas,
    }


def joints_loss(pred_pose: torch.Tensor, pred_betas: torch.Tensor,
                batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams,
                w: LossWeights, trans_scale: float = C.TRANS_SCALE,
                use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Joints-only supervised two-view loss for H36M-style GT (cam-frame 3D
    joints and their 2D projections, no SMPL-X parameters): kp2d with each
    camera's own intrinsics, pelvis-aligned kp3d plus the cross-view
    canonical-joint term, the pelvis as translation, the betas prior.
    ``use_kernels=False`` skins with the plain version on any device."""
    B = pred_pose.shape[0]
    trans = pred_pose[..., :3] / trans_scale
    rotmat = rot6d_to_rotmat(pred_pose[..., 3:].reshape(B, 2, 22, 6))

    _, joints = canonical_smplx_two_view(smplx_params, pred_betas, rotmat, use_kernels)
    intr = batch["intr"]
    focal = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], dim=-1)  # (B, 2, 2)
    cam_j, j2d = cam_frame_and_project(rotmat[:, :, 0], trans, joints, intr, focal)

    sel = list(SMPLX_TO_H36M17)
    pj3, pj2 = cam_j[:, :, sel], j2d[:, :, sel]
    gt3, gt2 = batch["gt_joints"], batch["gt_j2d"]

    loss_kp2d = _sq(pj2, gt2).mean(dim=(0, 2, 3)).sum()
    pa = pj3 - pj3[:, :, :1]        # pelvis-aligned (joint 0 = Hip)
    ga = gt3 - gt3[:, :, :1]
    j22 = joints[:, :, :22]
    loss_kp3d = _sq(pa, ga).mean(dim=(0, 2, 3)).sum() + _sq(j22[:, 0], j22[:, 1]).mean()
    loss_trans = _sq(cam_j[:, :, 0], gt3[:, :, 0]).mean(dim=(0, 2)).sum()
    loss_betas = _betas_twoview(pred_betas)

    total = w.total_scale * (w.trans * loss_trans + w.keypoint2d * loss_kp2d
                             + w.keypoint3d * loss_kp3d + w.beta * loss_betas)
    return total, {
        "loss": total,
        "loss_regr_trans": loss_trans,
        "loss_keypoints": loss_kp2d,
        "loss_keypoints_3d": loss_kp3d,
        "loss_regul_betas": loss_betas,
    }


def singleview_loss(pred_pose: torch.Tensor, pred_betas: torch.Tensor,
                    batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams,
                    w: LossWeights, trans_scale: float = C.TRANS_SCALE,
                    vertex_mask: Optional[torch.Tensor] = None,
                    use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Full-perspective single view, on view 0 of the batch layout:
    pred_pose (B, 135), pred_betas (B, 10). ``use_kernels=False`` skins
    with the plain version on any device."""
    B = pred_pose.shape[0]
    trans = pred_pose[:, :3] / trans_scale
    rotmat = rot6d_to_rotmat(pred_pose[:, 3:].reshape(B, 22, 6))

    out = smplx_forward(smplx_params, pred_betas, body_pose=rotmat[:, 1:],
                        global_orient=_identity_roots(B, pred_betas), use_kernels=use_kernels)
    _, j2d = cam_frame_and_project(rotmat[None, :, 0], trans[None], out.joints[None],
                                   batch["intr"][:, :1], C.FOCAL_LENGTH)
    j2d = j2d[0]

    loss_kp2d = _sq(j2d[:, :22], batch["gt_j2d"][:, 0, :22]).mean()
    e3d = _sq(out.joints[:, :22], batch["gt_joints"][:, :22])
    loss_kp3d = _limb_weight_joints(e3d, w.limbs3d).mean()
    verts_p, verts_g = out.vertices, batch["gt_vertices"]
    if vertex_mask is not None:
        verts_p = verts_p * vertex_mask[:, None]
        verts_g = verts_g * vertex_mask[:, None]
    loss_shape = _sq(verts_p, verts_g).mean()
    loss_trans = _sq(trans, batch["gt_trans"][:, 0]).mean()
    loss_rootrot = _sq(rotmat[:, 0], batch["gt_orient"][:, 0]).mean()
    epose = _sq(rotmat[:, 1:], batch["gt_pose_rotmat"])
    loss_pose = _limb_weight_rotmats(epose, w.limbstheta).mean()
    loss_betas = (pred_betas ** 2).mean()

    total = w.total_scale * (
        w.trans * loss_trans + w.keypoint2d * loss_kp2d + w.keypoint3d * loss_kp3d
        + w.shape * loss_shape + w.rootrot * loss_rootrot + w.pose * loss_pose
        + w.beta * loss_betas)
    return total, {
        "loss": total,
        "loss_regr_trans": loss_trans,
        "loss_keypoints": loss_kp2d,
        "loss_keypoints_3d": loss_kp3d,
        "loss_regr_shape": loss_shape,
        "loss_rootrot": loss_rootrot,
        "loss_regr_pose": loss_pose,
        "loss_regul_betas": loss_betas,
    }


def _weak_cam_project(rotmat_root, cam, joints, focal, img_res):
    """HMR-family weak-perspective reprojection in crop coordinates:
    cam (s, tx, ty) → translation [tx, ty, 2f/(res·s)], camera center 0."""
    cam_t = torch.stack([cam[:, 1], cam[:, 2], 2 * focal[0] / (img_res * cam[:, 0] + 1e-9)],
                        dim=-1)
    rot_j = torch.einsum("bij,bnj->bni", rotmat_root, joints) + cam_t[:, None]
    xy = rot_j[..., :2] / rot_j[..., 2:]
    return xy * torch.as_tensor(focal, dtype=xy.dtype, device=xy.device)


def hmr_loss(pred_pose6d: torch.Tensor, pred_betas: torch.Tensor, pred_cam: torch.Tensor,
             batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams, w: LossWeights,
             img_res: int = C.CROP_SIZE, vertex_mask: Optional[torch.Tensor] = None,
             use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Weak-perspective single view: pred_pose6d (B, 132), pred_betas
    (B, 10), pred_cam (B, 3). ``use_kernels=False`` skins with the plain
    version on any device."""
    B = pred_pose6d.shape[0]
    rotmat = rot6d_to_rotmat(pred_pose6d.reshape(B, 22, 6))
    out = smplx_forward(smplx_params, pred_betas, body_pose=rotmat[:, 1:],
                        global_orient=_identity_roots(B, pred_betas), use_kernels=use_kernels)
    j2d = _weak_cam_project(rotmat[:, 0], pred_cam, out.joints, C.FOCAL_LENGTH, img_res)

    loss_kp2d = _sq(j2d[:, :22], batch["gt_j2d_crop"][:, 0, :22]).mean()
    e3d = _sq(out.joints[:, :22], batch["gt_joints"][:, :22])
    loss_kp3d = _limb_weight_joints(e3d, w.limbs3d).mean()
    verts_p, verts_g = out.vertices, batch["gt_vertices"]
    if vertex_mask is not None:
        verts_p = verts_p * vertex_mask[:, None]
        verts_g = verts_g * vertex_mask[:, None]
    loss_shape = _sq(verts_p, verts_g).mean()
    loss_rootrot = _sq(rotmat[:, :1], batch["gt_orient"][:, :1]).mean()
    epose = _sq(rotmat[:, 1:], batch["gt_pose_rotmat"])
    loss_pose = _limb_weight_rotmats(epose, w.limbstheta).mean()
    loss_betas = (pred_betas ** 2).mean()
    barrier = (torch.exp(-pred_cam[:, 0] * 10) ** 2).mean()

    total = w.total_scale * (
        w.keypoint2d * loss_kp2d + w.keypoint3d * loss_kp3d + w.shape * loss_shape
        + w.rootrot * loss_rootrot + w.pose * loss_pose + w.beta * loss_betas + barrier)
    return total, {
        "loss": total,
        "loss_keypoints": loss_kp2d,
        "loss_keypoints_3d": loss_kp3d,
        "loss_regr_shape": loss_shape,
        "loss_rootrot": loss_rootrot,
        "loss_regr_pose": loss_pose,
        "loss_regul_betas": loss_betas,
    }


def muhmr_loss(pred_pose6d: torch.Tensor, pred_betas: torch.Tensor, pred_cam: torch.Tensor,
               batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams, w: LossWeights,
               img_res: int = C.CROP_SIZE, vertex_mask: Optional[torch.Tensor] = None,
               use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Two-view weak-perspective: per-view hmr terms, cross-view consistency
    on the body rotmats only, two camera barriers. pred_pose6d (B, 2, 132),
    pred_betas (B, 2, 10), pred_cam (B, 2, 3). ``use_kernels=False`` skins
    with the plain version on any device."""
    B = pred_pose6d.shape[0]
    rotmat = rot6d_to_rotmat(pred_pose6d.reshape(B, 2, 22, 6))
    verts, joints = canonical_smplx_two_view(smplx_params, pred_betas, rotmat, use_kernels)

    j2d = torch.stack([_weak_cam_project(rotmat[:, v, 0], pred_cam[:, v], joints[:, v],
                                         C.FOCAL_LENGTH, img_res) for v in (0, 1)], dim=1)
    gt_crop = batch["gt_j2d_crop"]
    loss_kp2d = (_sq(j2d[:, 0, :22], gt_crop[:, 0, :22]).mean()
                 + _sq(j2d[:, 1, :22], gt_crop[:, 1, :22]).mean())

    gt_joints = batch["gt_joints"]
    e3d = _sq(joints[:, 0, :22], gt_joints[:, :22]) + _sq(joints[:, 1, :22], gt_joints[:, :22])
    loss_kp3d = _limb_weight_joints(e3d, w.limbs3d).mean()

    gt_verts = batch["gt_vertices"]
    if vertex_mask is not None:
        verts = verts * vertex_mask[:, None]
        gt_verts = gt_verts * vertex_mask[:, None]
    loss_shape = _sq(verts[:, 0], gt_verts).mean() + _sq(verts[:, 1], gt_verts).mean()

    gt_orient = batch["gt_orient"]
    loss_rootrot = (_sq(rotmat[:, 0, :1], gt_orient[:, :1]).mean()
                    + _sq(rotmat[:, 1, :1], gt_orient[:, 1:2]).mean())

    gt_pose = batch["gt_pose_rotmat"]
    epose = (_sq(rotmat[:, 0, 1:], gt_pose) + _sq(rotmat[:, 1, 1:], gt_pose)
             + _sq(rotmat[:, 0, 1:], rotmat[:, 1, 1:]))
    loss_pose = _limb_weight_rotmats(epose, w.limbstheta).mean()

    loss_betas = (pred_betas[:, 0] ** 2).mean() + (pred_betas[:, 1] ** 2).mean()
    barrier = ((torch.exp(-pred_cam[:, 0, 0] * 10) ** 2).mean()
               + (torch.exp(-pred_cam[:, 1, 0] * 10) ** 2).mean())

    total = w.total_scale * (
        w.keypoint2d * loss_kp2d + w.keypoint3d * loss_kp3d + w.shape * loss_shape
        + w.rootrot * loss_rootrot + w.pose * loss_pose + w.beta * loss_betas + barrier)
    return total, {
        "loss": total,
        "loss_keypoints": loss_kp2d,
        "loss_keypoints_3d": loss_kp3d,
        "loss_regr_shape": loss_shape,
        "loss_rootrot": loss_rootrot,
        "loss_regr_pose": loss_pose,
        "loss_regul_betas": loss_betas,
    }


def real_twoview_loss(pred_pose: torch.Tensor, pred_betas: torch.Tensor,
                      batch: Dict[str, torch.Tensor], smplx_params: SMPLXParams,
                      vposer_params: VPoserParams, w: RealLossWeights,
                      generator: Optional[torch.Generator],
                      trans_scale: float = C.TRANS_SCALE,
                      use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Self-supervised two-view fine-tune loss on real captures:
    confidence-weighted 2D reprojection with limb weights, the VPoser
    latent L2, cross-view pose consistency, β regularizers and the
    exp(−t_z)² barrier. pred_pose (B, 2, 135), pred_betas (B, 2, 10);
    ``batch["gt_j2d_conf"]`` (B, 2, 22, 3) is [u, v, confidence] and
    ``batch["focal"]`` the per-view (2, 2) focal lengths; an optional
    ``batch["row_weight"]`` (B,) weights the rows of every term. ``generator``
    draws the latent sample; ``use_kernels=False`` skins with the plain
    version on any device."""
    B = pred_pose.shape[0]
    trans = pred_pose[..., :3] / trans_scale
    rotmat = rot6d_to_rotmat(pred_pose[..., 3:].reshape(B, 2, 22, 6))
    _, joints = canonical_smplx_two_view(smplx_params, pred_betas, rotmat, use_kernels)
    _, j2d = cam_frame_and_project(rotmat[:, :, 0], trans, joints, batch["intr"],
                                   batch.get("focal", C.FOCAL_LENGTH))

    rw = batch.get("row_weight")  # (B,) 1/0 mask of a padded eval batch; None in training
    kp = batch["gt_j2d_conf"]
    e2d = _sq(j2d[..., :22, :], kp[..., :22, :2]) * kp[..., :22, 2:]
    e2d = _limb_weight_joints(e2d, w.limbs2d)
    # the two views' weighted errors are summed before the mean: the term is
    # mean(view 0) + mean(view 1), not a mean over the views
    loss_kp2d = _row_mean(e2d.sum(dim=1), rw)

    # VPoser prior on the predicted body pose, both views folded; the two
    # views' terms summed
    pose_aa = rotmat_to_aa(rotmat[:, :, 1:]).reshape(B * 2, 63)
    z = vposer_rsample(*vposer_encode(vposer_params, pose_aa), generator)
    loss_vposer = _row_mean((z ** 2).reshape(B, 2, -1), rw) * 2.0

    loss_pose = _row_mean(_sq(rotmat[:, 0, 1:], rotmat[:, 1, 1:]), rw)
    loss_betas = (_row_mean(pred_betas[:, 0] ** 2, rw) + _row_mean(pred_betas[:, 1] ** 2, rw)
                  + _row_mean(_sq(pred_betas[:, 0], pred_betas[:, 1]), rw))
    barrier = (_row_mean(torch.exp(-trans[:, 0, 2]) ** 2, rw)
               + _row_mean(torch.exp(-trans[:, 1, 2]) ** 2, rw))

    total = w.total_scale * (w.keypoint2d * loss_kp2d + w.beta * loss_betas
                             + w.vposer * loss_vposer + w.pose * loss_pose + barrier)
    return total, {
        "loss": total,
        "loss_keypoints": loss_kp2d,
        "loss_regul_vposer": loss_vposer,
        "loss_regr_pose": loss_pose,
        "loss_regul_betas": loss_betas,
    }


def real_singleview_loss(pred_pose6d: torch.Tensor, pred_betas: torch.Tensor,
                         pred_cam: torch.Tensor, batch: Dict[str, torch.Tensor],
                         smplx_params: SMPLXParams, vposer_params: VPoserParams,
                         w: RealLossWeights, generator: Optional[torch.Generator],
                         focal=(5000.0, 5000.0), img_res: int = C.CROP_SIZE, view: int = 0,
                         use_kernels: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Self-supervised single-view loss of the real-data hmr variants
    (``hmr_camswap_difffl``, ``spin``): confidence-weighted crop-frame 2D
    keypoints of ``view`` through the weak-perspective camera at crop focal
    5000, the VPoser latent L2, β L2 and the camera-depth barrier
    exp(−t_z)². pred_pose6d (B, 132), pred_betas (B, 10), pred_cam (B, 3);
    ``batch["gt_j2d_crop_conf"]`` (B, V, 24, 3) is crop-frame
    [u, v, confidence]; an optional ``batch["row_weight"]`` (B,) weights the
    rows of every term."""
    B = pred_pose6d.shape[0]
    rotmat = rot6d_to_rotmat(pred_pose6d.reshape(B, 22, 6))
    out = smplx_forward(smplx_params, pred_betas, body_pose=rotmat[:, 1:],
                        global_orient=_identity_roots(B, pred_betas), use_kernels=use_kernels)
    cam_z = 2 * focal[0] / (img_res * pred_cam[:, 0] + 1e-9)
    j2d = _weak_cam_project(rotmat[:, 0], pred_cam, out.joints, focal, img_res)

    rw = batch.get("row_weight")  # (B,) 1/0 mask of a padded eval batch; None in training
    kp = batch["gt_j2d_crop_conf"][:, view]
    e2d = _sq(j2d[:, :22], kp[:, :22, :2]) * kp[:, :22, 2:]
    loss_kp2d = _row_mean(_limb_weight_joints(e2d, w.limbs2d), rw)

    pose_aa = rotmat_to_aa(rotmat[:, 1:]).reshape(B, 63)
    z = vposer_rsample(*vposer_encode(vposer_params, pose_aa), generator)
    loss_vposer = _row_mean(z ** 2, rw)
    loss_betas = _row_mean(pred_betas ** 2, rw)
    barrier = _row_mean(torch.exp(-cam_z) ** 2, rw)

    total = w.total_scale * (w.keypoint2d * loss_kp2d + w.beta * loss_betas
                             + w.vposer * loss_vposer + barrier)
    return total, {
        "loss": total,
        "loss_keypoints": loss_kp2d,
        "loss_regul_vposer": loss_vposer,
        "loss_regul_betas": loss_betas,
    }
