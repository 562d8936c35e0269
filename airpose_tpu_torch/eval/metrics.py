"""Evaluation metrics: MPJPE, MPE, PA-MPJPE (port of airpose_tpu/eval/metrics.py).

MPJPE and MPE follow the reference's test epoch: a per-view SMPL-X forward
of the predicted and the GT (pose, orient) with the root rotation as
``global_orient``, mean L2 over the first 22 joints; MPE is the
root-translation L2. PA-MPJPE aligns each sample by a similarity transform
first. The SMPL-X forwards skin through the CUDA kernel on the card unless
``use_kernels=False``.
"""

from typing import Dict

import torch

from ..bodymodel.smplx import SMPLXParams, smplx_forward
from ..data.joints import SMPLX_TO_H36M17


def canonical_joints(smplx_params: SMPLXParams, betas: torch.Tensor,
                     rotmat22: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """(N, 10) betas and (N, 22, 3, 3) [root | body] rotmats → (N, 22, 3)
    joints, the root rotation applied as ``global_orient``."""
    out = smplx_forward(smplx_params, betas, body_pose=rotmat22[:, 1:],
                        global_orient=rotmat22[:, :1], use_kernels=use_kernels)
    return out.joints[:, :22]


def mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error over the first 22 joints, unaligned."""
    return torch.sqrt(((pred_joints[:, :22] - gt_joints[:, :22]) ** 2).sum(dim=-1)).mean()


def mpe(pred_trans: torch.Tensor, gt_trans: torch.Tensor) -> torch.Tensor:
    """Mean root-translation error."""
    return torch.sqrt(((pred_trans - gt_trans) ** 2).sum(dim=-1)).mean()


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-sample similarity (rotation, translation, scale) alignment of
    ``pred`` onto ``gt``, both (N, J, 3): Umeyama through an f32 SVD of the
    cross-covariance, with the determinant fix against reflections."""
    mu_p, mu_g = pred.mean(dim=1, keepdim=True), gt.mean(dim=1, keepdim=True)
    pc, gc = pred - mu_p, gt - mu_g
    cov = torch.einsum("nji,njk->nik", gc, pc)
    U, S, Vt = torch.linalg.svd(cov.float())
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    R = U @ torch.diag_embed(d) @ Vt
    scale = (S * d).sum(dim=-1) / torch.clamp((pc ** 2).sum(dim=(1, 2)), min=1e-9)
    return scale[:, None, None] * torch.einsum("nij,nkj->nki", R, pc) + mu_g


def pa_mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE over the first 22 joints."""
    aligned = procrustes_align(pred_joints[:, :22], gt_joints[:, :22])
    return torch.sqrt(((aligned - gt_joints[:, :22]) ** 2).sum(dim=-1)).mean()


def twoview_eval_metrics(smplx_params: SMPLXParams, pred_rotmat: torch.Tensor,
                         pred_betas: torch.Tensor, pred_trans: torch.Tensor,
                         gt_pose_rotmat: torch.Tensor, gt_orient: torch.Tensor,
                         gt_betas: torch.Tensor, gt_trans: torch.Tensor,
                         use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """mpjpe, pa_mpjpe and mpe per view from pred_rotmat (N, 2, 22, 3, 3),
    pred_betas (N, 2, 10), pred_trans (N, 2, 3), gt_pose_rotmat
    (N, 21, 3, 3), gt_orient (N, 2, 3, 3), gt_betas (N, 10) and gt_trans
    (N, 2, 3), both views folded into one SMPL-X call for the prediction
    and one for the GT. The reference's quirk is kept: both sides take zero
    betas (its GT forward passes none), so the metrics compare pose-only
    bodies."""
    N = pred_rotmat.shape[0]
    gt_rm = torch.cat([gt_orient[:, :, None],
                       gt_pose_rotmat[:, None].expand((N, 2) + gt_pose_rotmat.shape[1:])],
                      dim=2)  # (N, 2, 22, 3, 3)

    def joints(betas, rotmat):
        zeros = betas.new_zeros(N * 2, betas.shape[-1])
        return canonical_joints(smplx_params, zeros, rotmat.reshape(N * 2, 22, 3, 3),
                                use_kernels).reshape(N, 2, 22, 3)

    pj, gj = joints(pred_betas, pred_rotmat), joints(gt_betas, gt_rm)
    terms = (("mpjpe", mpjpe, pj, gj), ("pa_mpjpe", pa_mpjpe, pj, gj),
             ("mpe", mpe, pred_trans, gt_trans))
    return {f"{name}{v}": fn(p[:, v], g[:, v]) for name, fn, p, g in terms for v in (0, 1)}


def h36m_eval_metrics(smplx_params: SMPLXParams, pred_rotmat: torch.Tensor,
                      pred_betas: torch.Tensor, pred_trans: torch.Tensor,
                      gt_joints: torch.Tensor, use_kernels: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """Joints-GT eval (H36M protocols 1 and 2, and MPE of the pelvis) per
    view over the 17 movable joints of ``SMPLX_TO_H36M17``, against
    cam-frame GT (N, 2, 17, 3). The prediction is skinned at identity root
    and then composed into the camera frame as R_root·j + t, the
    composition the losses train under (not the root-as-``global_orient``
    forward of ``canonical_joints``)."""
    N = pred_rotmat.shape[0]
    eye = torch.eye(3, dtype=pred_betas.dtype, device=pred_betas.device)
    out = smplx_forward(smplx_params, pred_betas.reshape(N * 2, -1),
                        body_pose=pred_rotmat[:, :, 1:].reshape(N * 2, 21, 3, 3),
                        global_orient=eye.expand(N * 2, 1, 3, 3), use_kernels=use_kernels)
    canon = out.joints.reshape(N, 2, -1, 3)[:, :, list(SMPLX_TO_H36M17)]
    cam_j = torch.einsum("nvij,nvkj->nvki", pred_rotmat[:, :, 0], canon) + pred_trans[:, :, None]
    res = {}
    for v in (0, 1):
        p, g = cam_j[:, v], gt_joints[:, v]
        pa, ga = p - p[:, :1], g - g[:, :1]  # root (Hip) alignment
        res[f"mpjpe{v}"] = torch.sqrt(((pa - ga) ** 2).sum(dim=-1)).mean()
        res[f"pa_mpjpe{v}"] = pa_mpjpe(p, g)
        res[f"mpe{v}"] = mpe(p[:, 0], g[:, 0])
    return res
