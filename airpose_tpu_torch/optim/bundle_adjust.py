"""AirPose+: post-hoc per-sequence bundle adjustment (port of
airpose_tpu/optim/bundle_adjust.py, the single-card path).

  variables   per-frame VPoser latent z (32), per-view root 6D rotation φ
              and translation τ, one shared β per chunk
  init        z = vposer.encode(AirPose pred pose).mean, φ/τ from AirPose's
              predictions
  loss        confidence-weighted Geman–McClure (σ = 30) 2D reprojection on
              BOTH the OpenPose and the AlphaPose sets, both views; β L2
              ×2000; VPoser z L2 ×0.05; temporal smoothness 10·Δθ +
              100·(Δφ0, Δφ1, Δτ0, Δτ1) on robust-adjacent frames; robust
              frames: AlphaPose confidence sum > 14; the hips' confidences
              halved
  schedule    Adam, lr 0.01; 100 iterations with z frozen, then 200 with all

As in the JAX package: the loss needs only the first 24 kinematic-chain
joints, so the inner loop runs a joints-only SMPL-X forward (no skinning of
the 10,475 vertices); the vertices are skinned once, at the export. The hip
down-weighting is applied once up front (the reference re-halves the
confidences every iteration), and the β regulariser penalises the optimised
β (the reference's penalises its constant init).

Each iteration is one forward, one backward and the Adam update on the
card, with nothing read back: the loss trace stays on the device until the
end of the run. ``bundle_adjust_sharded`` optimises a whole sequence with
its frames sharded over the ranks of a process group (parallel/mesh.py);
``--sharded`` runs it over the torchrun group, or over this process alone.
"""

import argparse
import dataclasses
import os
import pickle
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..parallel.launch import is_main_rank
from ..parallel.mesh import Mesh, make_mesh
from ..bodymodel import lbs as _lbs
from ..bodymodel.smplx import SMPLXParams
from ..bodymodel.vposer import VPoserParams, vposer_decode, vposer_encode
from ..geometry.robust import geman_mcclure
from ..geometry.rotations import batch_rodrigues, rot6d_to_rotmat, rotmat_to_rot6d


@dataclasses.dataclass(frozen=True)
class BAConfig:
    lr: float = 0.01
    iters_stage1: int = 100
    iters_stage2: int = 200
    sigma: float = 30.0
    w_beta: float = 2000.0
    w_vposer: float = 0.05
    w_temporal: float = 1.0
    w_temporal_theta: float = 10.0
    w_temporal_rigid: float = 100.0
    robust_conf_threshold: float = 14.0
    num_joints_2d: int = 24


class BAState(NamedTuple):
    z: torch.Tensor     # (N, 32)
    phi: torch.Tensor   # (N, 2, 6)
    tau: torch.Tensor   # (N, 2, 3)
    beta: torch.Tensor  # (10,)


def joints_only_forward(params: SMPLXParams, betas: torch.Tensor,
                        body_pose_rm: torch.Tensor) -> torch.Tensor:
    """Canonical (identity-root) kinematic-chain joints without skinning:
    shape blendshapes → joint regression → rigid chain. (B, 55, 3)."""
    B = betas.shape[0]
    v_shaped = params.v_template[None] + _lbs.blend_shapes(betas, params.shape_dirs)
    joints_rest = _lbs.vertices2joints(params.j_regressor, v_shaped)
    eye = torch.eye(3, dtype=betas.dtype, device=betas.device)
    hands = params.hand_pose.to(betas.dtype).expand((B,) + tuple(params.hand_pose.shape))
    full = torch.cat([eye.expand(B, 1, 3, 3), body_pose_rm, eye.expand(B, 3, 3, 3), hands],
                     dim=1)
    posed, _ = _lbs.batch_rigid_transform(full, joints_rest, params.parents)
    return posed


def init_from_predictions(vposer_params: VPoserParams, pred_pose_aa: torch.Tensor,
                          pred_trans: torch.Tensor) -> BAState:
    """AirPose's angles (N, 2, 22, 3) and translations (N, 2, 3) → the init:
    z from the view-0 body pose's VPoser mean, φ from each view's root
    rotation, τ from each view's translation."""
    N = pred_pose_aa.shape[0]
    with torch.no_grad():
        mu, _ = vposer_encode(vposer_params, pred_pose_aa[:, 0, 1:].reshape(N, 63))
        root_rm = batch_rodrigues(pred_pose_aa[:, :, 0])  # (N, 2, 3, 3)
    return BAState(z=mu, phi=rotmat_to_rot6d(root_rm), tau=pred_trans,
                   beta=pred_trans.new_zeros(10))


def _project(joints_cam: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    xy = joints_cam[..., :2] / joints_cam[..., 2:]
    f = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], dim=-1)
    c = intr[..., :2, 2]
    return xy * f[..., None, :] + c[..., None, :]


def _reprojection_terms(smplx_params, vposer_params, cfg: BAConfig, state: BAState,
                        keypoints, intr, robust_f, denom_2d):
    """The per-frame data terms: VPoser decode → kinematic joints → both
    views' GM reprojection of both keypoint sets, a sum over frames divided
    by ``denom_2d``. Returns (loss_2d, theta_aa)."""
    L = state.z.shape[0]
    J = cfg.num_joints_2d
    theta_aa = vposer_decode(vposer_params, state.z)["pose_body"].reshape(L, 63)
    body_rm = batch_rodrigues(theta_aa.reshape(L, 21, 3))
    joints = joints_only_forward(smplx_params, state.beta.expand(L, 10), body_rm)[:, :J]

    R = rot6d_to_rotmat(state.phi)  # (L, 2, 3, 3)
    cam_j = torch.einsum("nvij,nkj->nvki", R, joints) + state.tau[:, :, None, :]
    j2d = _project(cam_j, intr[None])  # (L, 2, J, 2)

    # both keypoint sets (OpenPose, AlphaPose), both views
    resid = j2d[:, None] - keypoints[..., :2]          # (L, 2 sets, 2 views, J, 2)
    # the reference applies GM to u and v separately, then weights by the
    # confidence and takes the mean: .sum(-1) / 2 keeps that mean
    rho = geman_mcclure(resid, cfg.sigma).sum(-1) / 2.0
    w2d = keypoints[..., 2] * robust_f[:, None, None, None]
    return (w2d * rho).sum() / denom_2d, theta_aa


def _weighted_tdiff(ext, pairw, denom):
    """Pair-weighted mean-square temporal difference over consecutive rows
    of ``ext`` (len = number of pairs + 1)."""
    d = (ext[1:] - ext[:-1]) ** 2
    d = d.reshape(d.shape[0], -1).mean(dim=-1)
    return (d * pairw).sum() / denom


def make_loss_fn(smplx_params: SMPLXParams, vposer_params: VPoserParams,
                 keypoints: torch.Tensor, intr: torch.Tensor, robust: torch.Tensor,
                 cfg: BAConfig):
    """keypoints (N, 2 sets, 2 views, 24, 3) [u, v, conf], intr (2, 3, 3),
    robust (N,) bool → ``loss_fn(state) → (total, {term: value})``."""
    robust_f = robust.float()
    robust_pair = robust_f[:-1] * robust_f[1:]
    denom_2d = torch.clamp(robust_f.sum() * cfg.num_joints_2d, min=1.0)
    denom_pairs = torch.clamp(robust_pair.sum(), min=1.0)

    def loss_fn(state: BAState):
        loss_2d, theta_aa = _reprojection_terms(smplx_params, vposer_params, cfg, state,
                                                keypoints, intr, robust_f, denom_2d)
        loss_vposer = (state.z ** 2).mean()
        loss_beta = (state.beta ** 2).mean()

        def tdiff(a):
            return _weighted_tdiff(a, robust_pair, denom_pairs)

        loss_temporal = (cfg.w_temporal_theta * tdiff(theta_aa)
                         + cfg.w_temporal_rigid * (tdiff(state.phi[:, 0]) + tdiff(state.phi[:, 1])
                                                   + tdiff(state.tau[:, 0])
                                                   + tdiff(state.tau[:, 1])))
        total = (loss_2d + cfg.w_beta * loss_beta + cfg.w_vposer * loss_vposer
                 + cfg.w_temporal * loss_temporal)
        return total, {"loss": total, "loss_2d": loss_2d, "loss_vposer": loss_vposer,
                       "loss_beta": loss_beta, "loss_temporal": loss_temporal}

    return loss_fn


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root) over a list of tensors, updated in place, written as
    train/state.py writes AMSGrad: bias corrections in f32, as optax
    computes them."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads, state: dict, params: List[torch.Tensor]) -> None:
        mu, nu = state["mu"], state["nu"]
        state["count"] += 1
        t = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        torch._foreach_lerp_(mu, list(grads), 1.0 - self.b1)    # b1·m + (1 − b1)·g
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, list(grads), list(grads), 1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        # p − lr · m̂ / (√v̂ + eps), m̂ = m / (1 − b1ᵗ), v̂ = v / (1 − b2ᵗ)
        torch._foreach_add_(params, torch._foreach_div(mu, denom), alpha=-self.lr / bc1)


def _observations(openpose: torch.Tensor, alphapose: torch.Tensor, cfg: BAConfig):
    """Both keypoint sets (N, 2, 24, 3) with the hips' confidences halved
    once, stacked to (N, 2 sets, 2 views, 24, 3), and the robust frames
    (AlphaPose's confidence sum above the threshold)."""
    def halve_hips(kp):
        kp = kp.clone()
        kp[:, :, [1, 2], 2] *= 0.5
        return kp

    kp = torch.stack([halve_hips(openpose), halve_hips(alphapose)], dim=1)
    return kp, alphapose[..., 2].sum(dim=(1, 2)) > cfg.robust_conf_threshold


def bundle_adjust(smplx_params: SMPLXParams, vposer_params: VPoserParams, init: BAState,
                  openpose: torch.Tensor, alphapose: torch.Tensor, intr: torch.Tensor,
                  cfg: BAConfig = BAConfig()) -> Tuple[BAState, Dict]:
    """The two-stage optimisation of one chunk: openpose and alphapose
    (N, 2, 24, 3), intr (2, 3, 3), on the device of ``init``. Each stage
    starts a fresh Adam state; stage 1 keeps z frozen (optax sees a zero
    gradient, so z's update is 0). Returns the optimised state and the
    metrics: ``trace[i]``, the loss after update i, and every loss term of
    the final state."""
    kp, robust = _observations(openpose, alphapose, cfg)
    loss_fn = make_loss_fn(smplx_params, vposer_params, kp, intr, robust, cfg)
    adam = Adam(cfg.lr)
    leaves = [t.detach().clone() for t in init]
    losses = []  # the loss before each update: after the one before it
    for train_z, n_iters in ((False, cfg.iters_stage1), (True, cfg.iters_stage2)):
        trainable = leaves if train_z else leaves[1:]
        for t in leaves:
            t.requires_grad_(any(t is u for u in trainable))
        opt_state = adam.init(trainable)
        for _ in range(n_iters):
            total, _ = loss_fn(BAState(*leaves))
            losses.append(total.detach())
            adam.update(torch.autograd.grad(total, trainable), opt_state, trainable)
    with torch.no_grad():
        for t in leaves:
            t.requires_grad_(False)
        state = BAState(*leaves)
        _, final = loss_fn(state)
    trace = torch.stack(losses[1:] + [final["loss"]]) if losses else torch.zeros(0)
    return state, {"trace": trace.cpu().numpy(), **{k: float(v) for k, v in final.items()}}


class _NextFirstRow(torch.autograd.Function):
    """The next rank's ``row`` (rank 0's on the last rank), by an all-gather;
    the backward all-gathers the ranks' gradients and takes the previous
    rank's, so each gradient goes back to the rank whose row it is."""

    @staticmethod
    def forward(ctx, row, group, rank, n):
        import torch.distributed as dist

        ctx.group, ctx.rank, ctx.n = group, rank, n
        parts = [torch.empty_like(row) for _ in range(n)]
        dist.all_gather(parts, row.contiguous(), group=group)
        return parts[(rank + 1) % n]

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        parts = [torch.empty_like(g) for _ in range(ctx.n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return parts[(ctx.rank - 1) % ctx.n], None, None, None


def bundle_adjust_sharded(smplx_params: SMPLXParams, vposer_params: VPoserParams,
                          init: BAState, openpose: torch.Tensor, alphapose: torch.Tensor,
                          intr: torch.Tensor, cfg: BAConfig = BAConfig(),
                          mesh: Mesh = None) -> Tuple[BAState, Dict]:
    """``bundle_adjust`` of the whole sequence with its frame axis sharded
    over ``mesh``'s data group (default: the process group, or this process
    alone); every rank passes the same whole inputs and gets the whole
    result. As in the JAX package (bundle_adjust.py:375-500):

    * the frames pad to a multiple of the rank count with zero-confidence,
      non-robust frames at a safe pose (identity 6D roots, τ_z = 10);
    * the per-frame variables (z, φ, τ) and keypoints split into contiguous
      blocks, one a rank; β is replicated and its gradient summed over the
      ranks, so every rank takes the same β step;
    * each rank's loss is its share of the global loss (the global
      denominators, β's and z's regularisers divided over the ranks), so the
      shares sum to ``bundle_adjust``'s loss;
    * the temporal pair that straddles a boundary reads the next rank's first
      frame inside the differentiated loss (``_NextFirstRow``, JAX's
      ``ppermute`` halo, whose transpose returns the cotangent to that rank);
      the pair from the last rank to rank 0 has weight 0, and non-robust
      frames drop their pairs, as on one device.

    Returns the unpadded state and ``trace`` (the global loss after each
    update), ``loss`` and the final terms, summed over the ranks."""
    import torch.distributed as dist

    if mesh is None:
        mesh = make_mesh()
    n, rank, group = mesh.n_data, mesh.data_rank, mesh.group
    N = int(init.z.shape[0])
    pad = (-N) % n
    kp, robust = _observations(openpose, alphapose, cfg)
    robust_f = robust.float()
    leaves = [t.detach() for t in init]
    if pad:
        kp = torch.cat([kp, kp.new_zeros((pad,) + tuple(kp.shape[1:]))])
        robust_f = torch.cat([robust_f, robust_f.new_zeros(pad)])
        z, phi, tau, beta = leaves
        eye6 = phi.new_tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).expand(pad, 2, 6)
        leaves = [torch.cat([z, z.new_zeros(pad, z.shape[1])]), torch.cat([phi, eye6]),
                  torch.cat([tau, tau.new_tensor([0.0, 0.0, 10.0]).expand(pad, 2, 3)]), beta]
    # global pair weights: pair i couples frames (i, i + 1); the last pair
    # (the wrap-around from the last rank to rank 0) is dead
    pairw = torch.cat([robust_f[:-1] * robust_f[1:], robust_f.new_zeros(1)])
    denom_2d = torch.clamp(robust_f.sum() * cfg.num_joints_2d, min=1.0)
    denom_pairs = torch.clamp(pairw.sum(), min=1.0)
    L = (N + pad) // n
    rows = slice(rank * L, (rank + 1) * L)
    kp_l, robust_l, pairw_l = kp[rows], robust_f[rows], pairw[rows]
    leaves = [t[rows].clone() for t in leaves[:3]] + [leaves[3].clone()]

    def halo(a):
        """The next rank's first row of ``a`` (rank 0's on the last rank)."""
        if group is None:
            return a[:1]
        return _NextFirstRow.apply(a[:1], group, rank, n)

    def shard_loss(state: BAState):
        loss_2d, theta_aa = _reprojection_terms(smplx_params, vposer_params, cfg, state,
                                                kp_l, intr, robust_l, denom_2d)
        # padded z rows stay 0: the mean's denominator is the true frame count
        loss_vposer = (state.z ** 2).sum() / (N * 32)
        loss_beta = (state.beta ** 2).mean() / n

        def tdiff(a):
            return _weighted_tdiff(torch.cat([a, halo(a)]), pairw_l, denom_pairs)

        loss_temporal = (cfg.w_temporal_theta * tdiff(theta_aa)
                         + cfg.w_temporal_rigid * (tdiff(state.phi[:, 0]) + tdiff(state.phi[:, 1])
                                                   + tdiff(state.tau[:, 0])
                                                   + tdiff(state.tau[:, 1])))
        total = (loss_2d + cfg.w_beta * loss_beta + cfg.w_vposer * loss_vposer
                 + cfg.w_temporal * loss_temporal)
        return total, {"loss": total, "loss_2d": loss_2d, "loss_vposer": loss_vposer,
                       "loss_beta": loss_beta, "loss_temporal": loss_temporal}

    adam = Adam(cfg.lr)
    losses = []  # this rank's share before each update
    for train_z, n_iters in ((False, cfg.iters_stage1), (True, cfg.iters_stage2)):
        trainable = leaves if train_z else leaves[1:]
        for t in leaves:
            t.requires_grad_(any(t is u for u in trainable))
        opt_state = adam.init(trainable)
        for _ in range(n_iters):
            total, _ = shard_loss(BAState(*leaves))
            losses.append(total.detach())
            grads = list(torch.autograd.grad(total, trainable))
            if group is not None:  # β is replicated: its step sees the global gradient
                dist.all_reduce(grads[-1], group=group)
            adam.update(grads, opt_state, trainable)
    with torch.no_grad():
        for t in leaves:
            t.requires_grad_(False)
        _, final = shard_loss(BAState(*leaves))
        trace = losses[1:] + [final["loss"]] if losses else []
        shares = torch.stack(trace + list(final.values()))
        if group is not None:
            dist.all_reduce(shares, group=group)
            parts = [[torch.empty_like(t) for _ in range(n)] for t in leaves[:3]]
            for out, t in zip(parts, leaves[:3]):
                dist.all_gather(out, t.contiguous(), group=group)
            leaves = [torch.cat(p)[:N] for p in parts] + [leaves[3]]
        else:
            leaves = [t[:N] for t in leaves[:3]] + [leaves[3]]
    terms = dict(zip(final, shares[len(trace):].tolist()))
    return BAState(*leaves), {"trace": shares[:len(trace)].cpu().numpy(), **terms}


def ba_debug_report(smplx_params: SMPLXParams, vposer_params: VPoserParams, init: BAState,
                    openpose: torch.Tensor, alphapose: torch.Tensor, intr: torch.Tensor,
                    cfg: BAConfig = BAConfig()) -> Dict[str, Dict]:
    """Numerical-health diagnostic, the reference's ``autograd.detect_anomaly``
    and bad-gradient visualiser: every loss term's value and, per
    optimisation variable (z, phi, tau, beta), its gradient's norm and
    finiteness at the INITIAL state, localising a NaN or Inf to (term,
    variable) before any Adam step can smear it over the whole state. Each
    term has its own backward, so that an Inf in the data term does not
    reach the regularisers' rows; a variable a term does not use gets a
    zero, finite gradient."""
    kp, robust = _observations(openpose, alphapose, cfg)
    loss_fn = make_loss_fn(smplx_params, vposer_params, kp, intr, robust, cfg)
    leaves = [t.detach().clone().requires_grad_(True) for t in init]
    _, metrics = loss_fn(BAState(*leaves))
    report: Dict[str, Dict] = {}
    for term in sorted(metrics):  # the JAX package's order
        value = metrics[term]
        grads = torch.autograd.grad(value, leaves, retain_graph=True, allow_unused=True)
        report[term] = {
            "value": float(value.detach()),
            "grads": {
                name: {"norm": float(torch.sqrt((g.float() ** 2).sum())) if g is not None
                       else 0.0,
                       "finite": bool(torch.isfinite(g).all()) if g is not None else True}
                for name, g in zip(BAState._fields, grads)},
        }
    return report


def print_debug_report(report: Dict[str, Dict]) -> bool:
    """Render the (term × variable) table; returns True if healthy."""
    fields = next(iter(report.values()))["grads"].keys()
    header = f"{'term':<14}{'value':>12}  " + "".join(f"{f'grad|{f}|':>14}" for f in fields)
    print(header, flush=True)
    healthy = True
    for term, row in report.items():
        cells = []
        for f in fields:
            g = row["grads"][f]
            cells.append(f"{g['norm']:>14.4g}" if g["finite"] else f"{'NON-FINITE':>14}")
            healthy &= g["finite"]
        ok = np.isfinite(row["value"])
        healthy &= bool(ok)
        val = f"{row['value']:>12.5g}" if ok else f"{'NON-FINITE':>12}"
        print(f"{term:<14}{val}  " + "".join(cells), flush=True)
    print("numerics: " + ("all finite" if healthy else "NON-FINITE terms/gradients above"),
          flush=True)
    return healthy


@torch.no_grad()
def export_results(smplx_params: SMPLXParams, vposer_params: VPoserParams, state: BAState,
                   use_kernels: bool = True) -> Dict[str, np.ndarray]:
    """The full-mesh export (one SMPL-X forward of the N bodies, skinned by
    the kernel on the card unless ``use_kernels=False``) and the
    relative-camera trajectory cam1-wrt-cam0: T_rel = T0 · T1⁻¹, T_v =
    [R_v | τ_v]."""
    from ..bodymodel.smplx import smplx_forward

    N = state.z.shape[0]
    dec = vposer_decode(vposer_params, state.z)
    eye = torch.eye(3, dtype=state.z.dtype, device=state.z.device)
    out = smplx_forward(smplx_params, state.beta.expand(N, 10),
                        body_pose=dec["pose_body_matrot"], global_orient=eye.expand(N, 1, 3, 3),
                        use_kernels=use_kernels)
    R = rot6d_to_rotmat(state.phi)
    verts = torch.einsum("nvij,nkj->nvki", R, out.vertices) + state.tau[:, :, None, :]
    T = torch.zeros((N, 2, 4, 4), dtype=R.dtype, device=R.device)
    T[:, :, 3, 3] = 1.0
    T[:, :, :3, :3] = R
    T[:, :, :3, 3] = state.tau
    T_rel = T[:, 0] @ torch.linalg.inv(T[:, 1])
    return {
        "verts0": verts[:, 0].cpu().numpy(),
        "verts1": verts[:, 1].cpu().numpy(),
        "pose_body": dec["pose_body"].cpu().numpy(),
        "beta": state.beta.cpu().numpy(),
        "cam1_wrt_cam0": T_rel.cpu().numpy(),
    }


# ---------------------------------------------------------------------------
# Sequence runner (the runnable script the reference's bundle_adj.py is)
# ---------------------------------------------------------------------------

def run_sequence(smplx_params: SMPLXParams, vposer_params: VPoserParams, dataset,
                 airpose_outputs, cfg: BAConfig = BAConfig(), chunk_size: int = 2000,
                 save_verts: bool = False, sharded: bool = False, debug_nans: bool = False):
    """Chunked per-sequence optimisation over a capture (``dataset``: a
    CopenetRealDataset or AircapDataset, for its keypoints and intrinsics;
    ``airpose_outputs``: the outputs pkl of ONE split): chunks of
    ``chunk_size`` frames, the temporal term coupling frames only within a
    chunk, on the device of the body models. ``sharded`` optimises the whole
    sequence jointly instead, its frames sharded over the process group
    (``bundle_adjust_sharded``; one rank without a group): no chunk
    boundaries, one β for the capture. Returns a result dict in the AirPose+
    export layout."""
    from ..eval.compile_results import outputs_to_ba_init

    init = outputs_to_ba_init(airpose_outputs, vposer_params)
    dev = init.z.device
    N = int(init.z.shape[0])
    n_frames = min(N, len(dataset))

    def keypoints(kp):  # (2, n, 24, 3) → (n, 2, 24, 3) on the card
        return torch.from_numpy(np.stack([kp[v, :n_frames] for v in (0, 1)], axis=1)).to(dev)

    openpose, alphapose = keypoints(dataset.opose), keypoints(dataset.apose)
    intr = torch.from_numpy(np.asarray(dataset.intr, np.float32)).to(dev)

    z = np.zeros((n_frames, 32), np.float32)
    phi = np.zeros((n_frames, 2, 6), np.float32)
    tau = np.zeros((n_frames, 2, 3), np.float32)
    betas, traces, verts0, verts1 = [], [], [], []
    cam1_wrt_cam0 = np.zeros((n_frames, 4, 4), np.float32)
    pose_body = np.zeros((n_frames, 21, 3), np.float32)

    def span(s, b, e):
        return BAState(z=s.z[b:e], phi=s.phi[b:e], tau=s.tau[b:e], beta=s.beta)

    if debug_nans:
        print_debug_report(ba_debug_report(smplx_params, vposer_params, span(init, 0, n_frames),
                                           openpose, alphapose, intr, cfg))

    spans = ([(0, n_frames)] if sharded
             else [(b, min(b + chunk_size, n_frames)) for b in range(0, n_frames, chunk_size)])
    for begin, end in spans:
        optimise = bundle_adjust_sharded if sharded else bundle_adjust
        state, metrics = optimise(smplx_params, vposer_params, span(init, begin, end),
                                  openpose[begin:end], alphapose[begin:end], intr, cfg)
        z[begin:end] = state.z.cpu().numpy()
        phi[begin:end] = state.phi.cpu().numpy()
        tau[begin:end] = state.tau.cpu().numpy()
        betas.append(state.beta.cpu().numpy())
        traces.append(metrics["trace"])
        # export in bounded slices whatever the optimisation span: the
        # plain skinning materialises (n, 10475, 4, 4) transforms, 1.34 GB
        # at 2,000 bodies (the export is frame-independent, so slicing
        # changes nothing)
        for eb in range(begin, end, chunk_size):
            ee = min(eb + chunk_size, end)
            exp = export_results(smplx_params, vposer_params, span(state, eb - begin, ee - begin))
            cam1_wrt_cam0[eb:ee] = exp["cam1_wrt_cam0"]
            pose_body[eb:ee] = exp["pose_body"]
            if save_verts:
                verts0.append(exp["verts0"])
                verts1.append(exp["verts1"])
        print(f"chunk [{begin}:{end}) final loss {metrics['loss']:.4f} "
              f"(2d {metrics['loss_2d']:.4f})", flush=True)

    result = {
        "z": z, "phi": phi, "tau": tau,
        "beta_per_chunk": np.stack(betas),
        "pose_body": pose_body,
        "cam1_wrt_cam0": cam1_wrt_cam0,
        "trace": np.concatenate(traces),
    }
    if save_verts:
        result["verts0"] = np.concatenate(verts0)
        result["verts1"] = np.concatenate(verts1)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="AirPose+: per-sequence bundle adjustment over a real capture, "
                    "initialised from an AirPose outputs pkl (the reference's bundle_adj.py "
                    "run contract), on one CUDA device.")
    p.add_argument("--datapath", required=True,
                   help="real://<dir>, aircap://<dir> or <dir> with the DJI layout")
    p.add_argument("--airpose-pkl", required=True, help="outputs pkl from eval.compile_results")
    p.add_argument("--split", default="test", choices=("test", "train"),
                   help="which split the pkl index holds (pkl order is the --split order "
                        "used at compile time)")
    p.add_argument("--split-index", type=int, default=None,
                   help="explicit index into the outputs pkl (overrides --split's "
                        "[test, train] assumption)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--vposer_ckpt", default=None)
    p.add_argument("--smplx_model_dir", default=None)
    p.add_argument("--synthetic_verts", type=int, default=10475)
    p.add_argument("--chunk-size", type=int, default=2000)
    p.add_argument("--sharded", action="store_true",
                   help="optimise the whole sequence jointly (no chunk boundaries in the "
                        "temporal term, one β for the capture), its frames sharded over "
                        "the ranks of torchrun --nproc-per-node N (one card a rank), or on "
                        "this process's device alone")
    p.add_argument("--iters1", type=int, default=100)
    p.add_argument("--iters2", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01,
                   help="Adam step size (the reference uses 0.01 over 100 + 200 iterations; "
                        "at much smaller iteration budgets a smaller lr avoids Adam's "
                        "initial overshoot from a near-converged AirPose init)")
    p.add_argument("--kp_threshold", type=float, default=50.0,
                   help="OpenPose/AlphaPose agreement gate")
    p.add_argument("--train_frames", type=int, nargs=2, default=(0, 7000))
    p.add_argument("--test_frames", type=int, nargs=2, default=(8000, 15000))
    p.add_argument("--save-verts", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="print the per-term × per-variable gradient finiteness and norm "
                        "table on the initial state before optimising")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (the CUDA card by default; raises without it)")
    return p


def optimize(args):
    """The CLI's work up to its result pkl: the models and the capture, the
    outputs pkl's split, run_sequence, and ``airpose_plus_<split>.pkl``
    under ``--out``. → (the AirPose outputs, the result, the pkl's path)."""
    from ..bodymodel import (init_vposer_params, load_smplx_npz, load_vposer_ckpt,
                             synthetic_smplx_params)
    from ..data import AircapDataset, CopenetRealDataset

    dev = resolve_device(args.platform)
    if args.sharded:
        from ..parallel.launch import init_from_env

        dev = init_from_env(dev) or dev
    if args.smplx_model_dir:
        smplx_params = load_smplx_npz(args.smplx_model_dir)
    else:
        smplx_params = synthetic_smplx_params(num_vertices=args.synthetic_verts)
    if args.vposer_ckpt:
        vposer_params = load_vposer_ckpt(args.vposer_ckpt)
    else:
        print("WARNING: no --vposer_ckpt; optimizing against a RANDOM VPoser prior — results "
              "will be meaningless outside tests.", flush=True)
        vposer_params = init_vposer_params(0)
    smplx_params, vposer_params = smplx_params.to(dev), vposer_params.to(dev)

    frange = (range(*args.test_frames) if args.split == "test" else range(*args.train_frames))
    if args.datapath.startswith("aircap://"):
        # the reference's aircapfit.py role: the same fit over an AirCap
        # capture (its one keypoint set in both slots, by the reader)
        ds = AircapDataset(args.datapath[len("aircap://"):], drange=frange)
    else:
        path = (args.datapath[len("real://"):] if args.datapath.startswith("real://")
                else args.datapath)
        ds = CopenetRealDataset(path, frame_range=frange, kp_agrmnt_threshold=args.kp_threshold)

    with open(args.airpose_pkl, "rb") as f:
        per_split = pickle.load(f)
    idx = args.split_index
    if idx is None:
        idx = 0 if args.split == "test" else min(1, len(per_split) - 1)
    outputs = per_split[idx]

    cfg = BAConfig(iters_stage1=args.iters1, iters_stage2=args.iters2, lr=args.lr)
    result = run_sequence(smplx_params, vposer_params, ds, outputs, cfg,
                          chunk_size=args.chunk_size, save_verts=args.save_verts,
                          sharded=args.sharded, debug_nans=args.debug_nans)
    out_pkl = os.path.join(args.out, f"airpose_plus_{args.split}.pkl")
    if is_main_rank():
        os.makedirs(args.out, exist_ok=True)
        with open(out_pkl, "wb") as f:
            pickle.dump(result, f)
    return outputs, result, out_pkl


def main(argv=None):
    from ..eval.figures import plot_trajectories, relative_camera_trajectory

    args = build_parser().parse_args(argv)
    outputs, result, out_pkl = optimize(args)
    if not is_main_rank():
        return
    # AirPose vs AirPose+ relative-camera trajectory
    n = result["cam1_wrt_cam0"].shape[0]
    trajs = {"AirPose": relative_camera_trajectory(outputs)[:n],
             "AirPose+": result["cam1_wrt_cam0"][:, :3, 3]}
    plot_path = os.path.join(args.out, f"cam_trajectory_{args.split}.png")
    plot_trajectories(trajs, plot_path)
    print(f"wrote {out_pkl} and {plot_path}")


if __name__ == "__main__":
    main()
