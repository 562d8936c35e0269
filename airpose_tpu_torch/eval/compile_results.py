"""Results compilation (port of airpose_tpu/eval/compile_results.py): the
reference's `*_res_compile.py` scripts as one CLI, on one CUDA device.

Runs a checkpoint over eval data, prints MPJPE / MPE (the reference's
test_epoch_end formulas) plus PA-MPJPE, and dumps the reference-compatible
"outputs" pkl, the interchange format the AirPose+ initializer
(``outputs_to_ba_init``) and the figure tooling (eval/figures.py) read:

    [ [ {"output": {numpy array dict}} per batch ]  per split ]

with keys pred_angles0/1, pred_smpltrans0/1, pred_betas0/1, pred_pose0/1,
gt_angles0/1, gt_smpltrans0/1, in_smpltrans0/1, smplorient_rel0/1,
smplpose_rotmat (+ the body fields with --save-full). The arrays have the
JAX package's keys, dtypes and shapes, so either package reads the other's
pkl.

Data paths:
  synthetic://N          generated fixture data (smoke)
  /path/to/aerialpeople  on-disk pkl dataset
  real:///path           DJI real layout, with the robust-frame cross-view
                         consistency metric (`err_idcs`)
  aircap:///path         an AirCap capture through the real compile pass
  h36m:///path           Human3.6M prebuilt db: root-aligned MPJPE /
                         PA-MPJPE / pelvis MPE (--split picks the camera
                         pair, train = 1/2, test = 3/4)
  totalcap:///path       TotalCapture prebuilt db, SMPL GT converted to the
                         synthetic contract per batch; splits 80/20

Flags and defaults are the JAX CLI's, with three differences: ``--platform
{cpu,cuda}`` (the card by default; raises without CUDA); ``--ckpt`` is a
checkpoint file the port's trainer writes (train.checkpoint.CheckpointManager;
the port reads no orbax directory); and ``--mesh N`` is the data-parallel
eval over the N ranks of ``torchrun --nproc-per-node N`` (one card a rank
with NCCL; gloo processes on the CPU), where the JAX CLI takes the first N
devices of one process: each rank evaluates its rows of every batch (a batch
whose rows do not divide N runs whole on every rank, as JAX replicates it),
every rank gathers the predictions, and rank 0 writes the outputs pkl, the
same rows in the same order as one process writes. N must be the group's
size (1 without torchrun).

Usage:
  python -m airpose_tpu_torch.eval.compile_results --model copenet_twoview \
      --ckpt <run>/checkpoints/last.ckpt --datapath <path> --split test train \
      --out results.pkl
"""

import argparse
import itertools
import json
import os
import pickle
from functools import partial
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from .. import constants as C
from .. import resolve_device
from ..parallel.launch import is_main_rank
from ..train.state import TrainState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sharded_eval(eval_step, mesh):
    """``eval_step`` (made with ``mesh``) over ``mesh``'s ranks: each rank
    evaluates its rows of the batch; every rank gets every row's
    predictions back, in order, and the metrics of the whole batch."""
    if mesh is None:
        return eval_step
    from ..parallel.mesh import gather_rows, shard_batch

    def step(state, batch):
        rows = int(batch["images"].shape[0])
        metrics, preds = eval_step(state, shard_batch(batch, mesh))
        return metrics, gather_rows(preds, mesh, rows)

    return step


def outputs_to_ba_init(outputs: List[Dict], vposer_params):
    """outputs pkl (one split) → AirPose+ BAState init, on the device of
    ``vposer_params``."""
    from ..optim.bundle_adjust import init_from_predictions

    dev = vposer_params.enc_fc1.w.device
    cat = {k: np.concatenate([o["output"][k] for o in outputs])
           for k in ("pred_angles0", "pred_angles1", "pred_smpltrans0", "pred_smpltrans1")}
    aa = torch.from_numpy(np.stack([cat["pred_angles0"], cat["pred_angles1"]], axis=1))
    trans = torch.from_numpy(np.stack([cat["pred_smpltrans0"], cat["pred_smpltrans1"]],
                                      axis=1))
    return init_from_predictions(vposer_params, aa.to(dev), trans.to(dev))


# ---------------------------------------------------------------------------
# batch sources
# ---------------------------------------------------------------------------

def _padded_ranges(n: int, batch_size: int):
    """Cover all n frames in fixed-shape batches: the final partial batch is
    padded by repeating the last frame and tagged with its valid count
    (nothing is dropped; the reference evaluates complete DataLoaders).
    Yields (index list of len batch_size, n_valid)."""
    for s in range(0, n, batch_size):
        k = min(batch_size, n - s)
        yield list(range(s, s + k)) + [n - 1] * (batch_size - k), k


def _pop_valid(batch: Dict) -> int:
    """Valid-row count of a possibly tail-padded eval batch (removed from
    the dict, so the step functions never see the tag)."""
    return int(batch.pop("_valid", batch["images"].shape[0]))


def synthetic_batches(data: Dict[str, torch.Tensor], batch_size: int) -> Iterable[Dict]:
    """Tail-padded batches of a make_synthetic_dataset dict, on its device."""
    n = data["images"].shape[0]
    for idx, k in _padded_ranges(n, batch_size):
        b = {key: v[torch.tensor(idx, device=v.device)] for key, v in data.items()}
        b["_valid"] = k
        yield b


def _generator(device) -> torch.Generator:
    """The eval batches' jitter generator (unused: the crops are
    deterministic), seeded 0 as the JAX package's PRNGKey(0)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


def aerialpeople_batches(ds, batch_size: int, out_size: int = 224,
                         device=None) -> Iterable[Dict]:
    """Deterministic on-disk eval batches: no camera swap, no crop jitter;
    the trainer's on-disk batch completion with deterministic=True."""
    from ..data.pipeline import finish_batch

    rng_np, gen = np.random.default_rng(0), _generator(device)
    for idx, k in _padded_ranges(len(ds), batch_size):
        hb = ds.host_batch(idx, rng_np, swap_cams=False)
        gt = ds.canonical_gt(idx)
        hb["gt_vertices"] = gt["vertices"]
        hb["gt_joints"] = gt["joints"]
        hb["gt_j2d"] = hb["gt_j2d"][:, :, :22]
        b = finish_batch(hb, gen, deterministic=True, out_size=out_size, device=device)
        b["_valid"] = k
        yield b


def h36m_batches(ds, batch_size: int, out_size: int = 224, device=None) -> Iterable[Dict]:
    """Deterministic Human3.6M eval batches (no camera swap, no crop
    jitter), tail-padded and tagged like every other eval source."""
    from ..data.pipeline import finish_batch

    rng_np, gen = np.random.default_rng(0), _generator(device)
    for idx, k in _padded_ranges(len(ds), batch_size):
        hb = ds.host_batch(idx, rng_np, swap_cams=False)
        b = finish_batch(hb, gen, deterministic=True, out_size=out_size, device=device)
        b["_valid"] = k
        yield b


def totalcap_batches(ds, smplx_params, batch_size: int, out_size: int = 224,
                     indices=None, device=None) -> Iterable[Dict]:
    """Deterministic TotalCapture eval batches: the SMPL parameter GT is
    converted to the synthetic two-view contract per batch
    (data.totalcap.twoview_gt_from_smpl), so compile_twoview's metrics and
    outputs pkl apply unchanged. ``indices`` restricts to a frame subset
    (e.g. the trainer's held-out 20%)."""
    from ..data.pipeline import finish_batch
    from ..data.totalcap import twoview_gt_from_smpl

    rng_np, gen = np.random.default_rng(0), _generator(device)
    idx_all = list(indices) if indices is not None else list(range(len(ds)))
    rows = getattr(ds, "_canon_rows", None)
    if (getattr(ds, "_canon_cache", None) is None
            or (rows is not None and any(i not in rows for i in idx_all))):
        # one SMPL-X pass, restricted to the frames this eval consumes
        ds.precompute_canonical_gt(smplx_params, indices=idx_all)
    for idx, k in _padded_ranges(len(idx_all), batch_size):
        abs_idx = [idx_all[i] for i in idx]
        hb = ds.host_batch(abs_idx, rng_np, swap_cams=False)
        hb = twoview_gt_from_smpl(hb, smplx_params, ds=ds, indices=abs_idx)
        b = finish_batch(hb, gen, deterministic=True, out_size=out_size, device=device)
        b["_valid"] = k
        yield b


def real_batches(ds, batch_size: int, out_size: int = 224, device=None) -> Iterable[Dict]:
    """Deterministic real-data eval batches in the dataset's pinned camera
    order (the reference evaluates with shuffle_cams off)."""
    from ..data.pipeline import finish_batch

    dev = resolve_device(device)
    # the focal pair follows the dataset's VIEW order: with first_cam=1 the
    # reader swaps the views, so the pair swaps with them (cam1's focal is
    # ~12% shorter than cam0's). The pair comes from the dataset: the DJI
    # constants for real://, the capture's own intrinsics for aircap://.
    if getattr(ds, "shuffle_cams", False):
        raise ValueError("eval requires a fixed camera order")
    pair = ds.focal_pairs()
    if getattr(ds, "first_cam", 0) == 1:
        pair = pair[::-1]
    focal = torch.tensor(pair, dtype=torch.float32, device=dev)
    rng_np, gen = np.random.default_rng(0), _generator(dev)
    for idx, k in _padded_ranges(len(ds), batch_size):
        hb = ds.host_batch(idx, rng_np)
        b = finish_batch(hb, gen, deterministic=True, margin=0.0, out_size=out_size,
                         device=dev)
        b["gt_j2d_conf"] = b["gt_j2d_conf"][:, :, :22]
        b["focal"] = focal
        # 1/0 mask over rows: the eval loss drops the tail batch's pad rows
        # exactly (losses._row_mean); predictions are sliced host-side
        b["row_weight"] = torch.from_numpy(
            (np.arange(batch_size) < k).astype(np.float32)).to(dev)
        b["_valid"] = k
        yield b


# ---------------------------------------------------------------------------
# compile passes
# ---------------------------------------------------------------------------

class _Int8Forward(nn.Module):
    """The eval forward of an ``Int8Inference`` shim as a module with no
    tensors of its own: the step factories apply their model with the
    state's tensors, and the state handed with this module holds none."""

    def __init__(self, shim):
        super().__init__()
        self.shim = shim

    def forward(self, images, *args, iters=None, train=False, generator=None):
        return self.shim.apply(images, *args, iters=iters, train=train)


def _int8_shim(model, state, batches, calib_n: int = 8):
    """Peek enough leading batches for ``calib_n`` calibration images, wrap
    ``model`` in the Int8Inference shim (its trunk quantized from the
    model's own tensors, which are the state's), and print the activation
    clip rates under the calibrated scales, measured out of sample on the
    first batch past the calibration prefix (abs-max calibration clips ~0
    of its own images). → (module for the step factories, a state without
    tensors, the batches with the peeked ones first)."""
    from ..ops.int8_trunk import Int8Inference

    batches = iter(batches)
    peeked, imgs = [], []
    n_imgs = 0
    while n_imgs < calib_n:
        try:
            b = next(batches)
        except StopIteration:
            break
        peeked.append(b)
        im = b["images"]
        if im.ndim == 5:  # canonical (B, 2, H, W, 3) batches: fold views
            im = im.reshape((-1,) + tuple(im.shape[2:]))
        imgs.append(im)
        n_imgs += im.shape[0]
    shim = Int8Inference(model, torch.cat(imgs)[:calib_n])
    held_out = True
    try:
        peeked.append(next(batches))
    except StopIteration:
        held_out = False
    rates = shim.clip_report(peeked[-1]["images"])
    vals = np.asarray(list(rates.values()))
    worst = max(rates, key=rates.get)
    print(f"int8 calibration: {min(n_imgs, calib_n)} images; "
          f"{'held-out' if held_out else 'IN-SAMPLE (dataset exhausted)'} "
          f"clip rate mean {vals.mean():.2e}, max {vals.max():.2e} "
          f"({worst}) over {len(rates)} tensors", flush=True)
    bare = TrainState(step=state.step, params={}, batch_stats={}, opt_state=None)
    return _Int8Forward(shim), bare, itertools.chain(peeked, batches)


def _on(smplx_params, a) -> torch.Tensor:
    """numpy → f32 tensor on the body model's device."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        smplx_params.v_template.device)


@torch.no_grad()
def _full_body_fields(smplx_params, rotmat, betas, trans, intr, focal, in_trans,
                      use_kernels: bool = True):
    """The reference is_test output's body-derived fields, suffixed per
    view: cam-frame vertices and joints through the identity-root forward
    and the origin-pivot composition, their 2D projection (per-view
    ``focal``, per-sample principal point), and the zero-β "input" mesh at
    the IEF init translation. numpy in and out: rotmat (B, 2, 22, 3, 3);
    in_trans (B, 2, 3)."""
    from ..bodymodel.smplx import smplx_forward
    from ..train.losses import cam_frame_and_project

    B = rotmat.shape[0]
    rm, tr = _on(smplx_params, rotmat), _on(smplx_params, trans)
    root = rm[:, :, 0]
    body_pose = rm[:, :, 1:].reshape(B * 2, 21, 3, 3)
    eye = torch.eye(3, device=rm.device).expand(B * 2, 1, 3, 3)
    body = smplx_forward(smplx_params, _on(smplx_params, betas.reshape(B * 2, 10)),
                         body_pose=body_pose, global_orient=eye, use_kernels=use_kernels)
    verts = body.vertices.reshape((B, 2) + tuple(body.vertices.shape[1:]))
    joints = body.joints.reshape((B, 2) + tuple(body.joints.shape[1:]))
    cam_v = torch.einsum("bvij,bvnj->bvni", root, verts) + tr[:, :, None]
    cam_j, j2d = cam_frame_and_project(root, tr, joints, _on(smplx_params, intr),
                                       _on(smplx_params, focal))
    # zero-β input mesh at the init translation (identity root)
    body_in = smplx_forward(smplx_params, torch.zeros((B * 2, 10), device=rm.device),
                            body_pose=body_pose, global_orient=eye, use_kernels=use_kernels)
    verts_in = (body_in.vertices.reshape((B, 2) + tuple(body_in.vertices.shape[1:]))
                + _on(smplx_params, in_trans)[:, :, None])
    f = {}
    for v in (0, 1):
        f[f"pred_vertices_cam{v}"] = _np(cam_v[:, v])
        f[f"pred_j3d_cam{v}"] = _np(cam_j[:, v])
        f[f"pred_j2d_cam{v}"] = _np(j2d[:, v])
        f[f"pred_vertices_cam_in{v}"] = _np(verts_in[:, v])
    return f


def compile_twoview(state, model, smplx_params, batches: Iterable[Dict], cfg,
                    save_full=False, int8=False, int8_calib_n=8,
                    use_kernels: bool = True, device=None, mesh=None):
    """Eval every batch, return (outputs list, metrics dict).

    ``int8`` evaluates the int8 PTQ serving configuration instead of the
    model's trunk (ops/int8_trunk.py), calibrated on the first
    ``int8_calib_n`` eval images (clip rates printed, see _int8_shim).
    ``use_kernels=False`` skins with the plain version. Runs on ``device``
    (CUDA by default; raises without it), where the model, the body model
    and the batches are; with ``mesh``, each rank evaluates its rows of every
    batch (``_sharded_eval``)."""
    from ..eval.metrics import twoview_eval_metrics
    from ..geometry.rotations import rotmat_to_aa
    from ..train.losses import twoview_loss
    from ..train.loop import make_twoview_step_fns
    from ..train.state import make_optimizer

    if int8:
        model, state, batches = _int8_shim(model, state, batches, int8_calib_n)
    _, eval_step = make_twoview_step_fns(
        model, smplx_params, cfg, make_optimizer(cfg.lr),
        loss=partial(twoview_loss, use_kernels=use_kernels), device=device, mesh=mesh)
    eval_step = _sharded_eval(eval_step, mesh)

    outputs = []
    acc = {k: [] for k in ("rotmat", "betas", "trans", "gt_pose", "gt_orient", "gt_betas",
                           "gt_trans")}
    for batch in batches:
        valid = _pop_valid(batch)
        B = int(batch["images"].shape[0])
        _, preds = eval_step(state, batch)
        pred_rotmat = preds["pred_rotmat"]
        gt_orient, gt_pose = batch["gt_orient"], batch["gt_pose_rotmat"]
        gt_rm = torch.cat([gt_orient[:, :, None],
                           gt_pose[:, None].expand((B, 2) + tuple(gt_pose.shape[1:]))], dim=2)
        pred_angles, gt_angles = _np(rotmat_to_aa(pred_rotmat)), _np(rotmat_to_aa(gt_rm))
        pred_rotmat = _np(pred_rotmat)
        pred_trans, pred_betas = _np(preds["pred_trans"]), _np(preds["pred_betas"])
        gt_orient, gt_pose, gt_trans = _np(gt_orient), _np(gt_pose), _np(batch["gt_trans"])
        in_trans = np.tile([0, 0, 10.0], (B, 1)).astype(np.float32)

        out = {
            "pred_angles0": pred_angles[:, 0], "pred_angles1": pred_angles[:, 1],
            "pred_smpltrans0": pred_trans[:, 0], "pred_smpltrans1": pred_trans[:, 1],
            "pred_betas0": pred_betas[:, 0], "pred_betas1": pred_betas[:, 1],
            "gt_angles0": gt_angles[:, 0], "gt_angles1": gt_angles[:, 1],
            "gt_smpltrans0": gt_trans[:, 0], "gt_smpltrans1": gt_trans[:, 1],
            "in_smpltrans0": in_trans, "in_smpltrans1": in_trans.copy(),
            "smplorient_rel0": gt_orient[:, 0:1],
            "smplorient_rel1": gt_orient[:, 1:2],
            "smplpose_rotmat": gt_pose,
        }
        if save_full:
            out.update(_full_body_fields(
                smplx_params, pred_rotmat, pred_betas, pred_trans, _np(batch["intr"]),
                C.FOCAL_LENGTH, np.stack([in_trans, in_trans], axis=1), use_kernels))
        # padded tail rows are duplicates of the last frame: keep them out
        # of the outputs pkl and the metric accumulators
        outputs.append({"output": {k: v[:valid] for k, v in out.items()}})
        for k, v in (("rotmat", pred_rotmat), ("betas", pred_betas), ("trans", pred_trans),
                     ("gt_pose", gt_pose), ("gt_orient", gt_orient),
                     ("gt_betas", _np(batch["gt_betas"])), ("gt_trans", gt_trans)):
            acc[k].append(v[:valid])

    cat = {k: _on(smplx_params, np.concatenate(v)) for k, v in acc.items()}
    metrics = twoview_eval_metrics(
        smplx_params, cat["rotmat"], cat["betas"], cat["trans"], cat["gt_pose"],
        cat["gt_orient"], cat["gt_betas"], cat["gt_trans"], use_kernels=use_kernels)
    return outputs, {k: float(v) for k, v in metrics.items()}


def compile_h36m_twoview(state, model, smplx_params, batches: Iterable[Dict], cfg,
                         int8=False, int8_calib_n=8, use_kernels: bool = True, device=None,
                         mesh=None):
    """Eval over h36m:// batches: outputs-pkl rows (pred angles, trans and
    betas, and the 17-joint cam-frame GT) and the H36M metrics, root-aligned
    MPJPE (protocol 1), PA-MPJPE (protocol 2) and pelvis MPE per view
    (metrics.h36m_eval_metrics). ``int8``, ``use_kernels``, ``device`` and
    ``mesh`` as in compile_twoview."""
    from ..eval.metrics import h36m_eval_metrics
    from ..geometry.rotations import rotmat_to_aa
    from ..train.losses import joints_loss
    from ..train.loop import make_twoview_step_fns
    from ..train.state import make_optimizer

    if int8:
        model, state, batches = _int8_shim(model, state, batches, int8_calib_n)
    _, eval_step = make_twoview_step_fns(
        model, smplx_params, cfg, make_optimizer(cfg.lr),
        loss=partial(joints_loss, use_kernels=use_kernels), device=device, mesh=mesh)
    eval_step = _sharded_eval(eval_step, mesh)

    outputs = []
    pr_l, pb_l, pt_l, gj_l = [], [], [], []
    for batch in batches:
        valid = _pop_valid(batch)
        _, preds = eval_step(state, batch)
        pred_angles = _np(rotmat_to_aa(preds["pred_rotmat"][:valid]))
        pred_rotmat = _np(preds["pred_rotmat"])[:valid]
        pred_trans = _np(preds["pred_trans"])[:valid]
        pred_betas = _np(preds["pred_betas"])[:valid]
        gt_j = _np(batch["gt_joints"])[:valid]
        outputs.append({"output": {
            "pred_angles0": pred_angles[:, 0],
            "pred_angles1": pred_angles[:, 1],
            "pred_smpltrans0": pred_trans[:, 0],
            "pred_smpltrans1": pred_trans[:, 1],
            "pred_betas0": pred_betas[:, 0], "pred_betas1": pred_betas[:, 1],
            "gt_joints_cam0": gt_j[:, 0], "gt_joints_cam1": gt_j[:, 1],
        }})
        pr_l.append(pred_rotmat)
        pb_l.append(pred_betas)
        pt_l.append(pred_trans)
        gj_l.append(gt_j)

    metrics = h36m_eval_metrics(
        smplx_params, *(_on(smplx_params, np.concatenate(a)) for a in (pr_l, pb_l, pt_l, gj_l)),
        use_kernels=use_kernels)
    return outputs, {k: float(v) for k, v in metrics.items()}


def compile_singleview(state, model, smplx_params, batches: Iterable[Dict], cfg, family,
                       int8=False, int8_calib_n=8, use_kernels: bool = True, device=None,
                       mesh=None):
    """Eval the hmr / muhmr / copenet_singleview families: outputs pkl in
    the reference single-view format (pred_angles; pred_smpltrans through
    the weak-camera reprojection for the weak families) and MPJPE /
    PA-MPJPE / MPE. ``int8``, ``use_kernels``, ``device`` and ``mesh`` as in
    compile_twoview."""
    from ..eval.metrics import canonical_joints, mpe, mpjpe, pa_mpjpe
    from ..geometry.projection import weak_cam_crop_to_full_trans
    from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
    from ..train.loop import make_singleview_step_fns
    from ..train.state import make_optimizer

    if int8:
        model, state, batches = _int8_shim(model, state, batches, int8_calib_n)
    _, eval_step = make_singleview_step_fns(model, smplx_params, cfg, make_optimizer(cfg.lr),
                                            family, use_kernels=use_kernels, device=device,
                                            mesh=mesh)
    eval_step = _sharded_eval(eval_step, mesh)

    outputs = []
    rms, betas_all, trans_all, gt_trans_all = [], [], [], []
    for batch in batches:
        valid = _pop_valid(batch)
        B = int(batch["images"].shape[0])
        _, out = eval_step(state, batch)
        if family == "copenet_singleview":
            trans = out.pose[:, :3] / cfg.trans_scale
            rotmat = rot6d_to_rotmat(out.pose[:, 3:].reshape(-1, 22, 6))
        else:
            rotmat = rot6d_to_rotmat(out.pose6d.reshape(-1, 22, 6))
            cam = out.cam
            if family == "muhmr":
                rotmat = rotmat.reshape(B, 2, 22, 3, 3)[:, 0]
                cam = cam[:, 0]
            trans = weak_cam_crop_to_full_trans(cam, batch["bb"][:, 0], batch["intr"][:, 0],
                                                C.FOCAL_LENGTH, cfg.img_res)
        betas = out.betas
        if betas.ndim == 3:
            betas = betas[:, 0]
        gt_rm = torch.cat([batch["gt_orient"][:, 0, None], batch["gt_pose_rotmat"]], dim=1)
        angles, gt_angles = _np(rotmat_to_aa(rotmat)), _np(rotmat_to_aa(gt_rm))
        rotmat, betas, trans, gt_rm = _np(rotmat), _np(betas), _np(trans), _np(gt_rm)
        gt_trans = _np(batch["gt_trans"])[:, 0]
        outputs.append({"output": {
            "pred_angles": angles[:valid],
            "pred_betas": betas[:valid],
            "pred_smpltrans": trans[:valid],
            "gt_angles": gt_angles[:valid],
            "gt_smpltrans": gt_trans[:valid],
        }})
        rms.append((rotmat[:valid], gt_rm[:valid]))
        betas_all.append(betas[:valid])
        trans_all.append(trans[:valid])
        gt_trans_all.append(gt_trans[:valid])

    pred_rm = _on(smplx_params, np.concatenate([r[0] for r in rms]))
    gt_rm = _on(smplx_params, np.concatenate([r[1] for r in rms]))
    zeros = torch.zeros((pred_rm.shape[0], 10), device=pred_rm.device)
    with torch.no_grad():
        pj = canonical_joints(smplx_params, zeros, pred_rm, use_kernels)
        gj = canonical_joints(smplx_params, zeros, gt_rm, use_kernels)
    metrics = {
        "mpjpe": float(mpjpe(pj, gj)),
        "pa_mpjpe": float(pa_mpjpe(pj, gj)),
        "mpe": float(mpe(_on(smplx_params, np.concatenate(trans_all)),
                         _on(smplx_params, np.concatenate(gt_trans_all)))),
    }
    return outputs, metrics


@torch.no_grad()
def robust_crossview_consistency(smplx_params, pred_rotmat: np.ndarray,
                                 pred_betas: np.ndarray, extr: np.ndarray,
                                 err_idcs: np.ndarray, use_kernels: bool = True) -> float:
    """The reference's real-data accuracy proxy (no 3D GT): root-relative
    3D joints of each view, transformed into the world frame, must agree;
    mean per-joint L2 over robust frames. pred_rotmat (N, 2, 22, 3, 3),
    pred_betas (N, 2, 10), extr (N, 2, 4, 4) per-frame camera extrinsics,
    err_idcs (N,) bool robust-frame mask.

    The reference's joints are the ORIGIN-pivot cam-frame joints (an
    identity-root forward, then the root rotation), so root-relative world
    joints reduce to R_extrᵀ · R_root · canonical identity-root joints (the
    translations cancel; a root-in-model forward would pivot at the root
    joint and add per-view (I − R_root)·j0 terms the reference does not
    have). The difference runs over all 127 SMPL-X joints, as the
    reference differences its full joint set."""
    from ..bodymodel.smplx import smplx_forward

    N = pred_rotmat.shape[0]
    rm = _on(smplx_params, pred_rotmat)
    body = smplx_forward(smplx_params, _on(smplx_params, pred_betas.reshape(N * 2, 10)),
                         body_pose=rm[:, :, 1:].reshape(N * 2, 21, 3, 3),
                         global_orient=torch.eye(3, device=rm.device).expand(N * 2, 1, 3, 3),
                         use_kernels=use_kernels)
    pj = body.joints.reshape((N, 2) + tuple(body.joints.shape[1:]))
    pj = torch.einsum("nvij,nvkj->nvki", rm[:, :, 0], pj)
    world = torch.einsum("nvji,nvkj->nvki", _on(smplx_params, extr[:, :, :3, :3]), pj)
    d = torch.sqrt(((world[:, 0] - world[:, 1]) ** 2).sum(dim=-1))  # (N, J)
    mask = _on(smplx_params, np.asarray(err_idcs))[:, None]
    return float((d * mask).sum() / torch.clamp(mask.sum() * d.shape[1], min=1.0))


def compile_real_twoview(state, model, smplx_params, vposer_params, ds, batch_size: int,
                         cfg, save_full=False, err_idcs: Optional[np.ndarray] = None,
                         out_size: int = 224, int8=False, int8_calib_n=8,
                         use_kernels: bool = True, device=None, mesh=None):
    """Real-data (self-supervised regime) compile: outputs pkl with the raw
    135-d pose state per view (the benchtest interchange) and the robust
    cross-view consistency metric; no 3D GT exists on this path. ``int8``,
    ``use_kernels``, ``device`` and ``mesh`` as in compile_twoview."""
    from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
    from ..train.loop import make_real_twoview_step_fns
    from ..train.state import make_optimizer

    batches = real_batches(ds, batch_size, out_size=out_size, device=device)
    if int8:
        model, state, batches = _int8_shim(model, state, batches, int8_calib_n)
    _, eval_step = make_real_twoview_step_fns(model, smplx_params, vposer_params, cfg,
                                              make_optimizer(cfg.lr), use_kernels=use_kernels,
                                              device=device, mesh=mesh)
    eval_step = _sharded_eval(eval_step, mesh)

    outputs, losses = [], []
    all_rotmat, all_betas, all_extr = [], [], []
    for batch in batches:
        valid = _pop_valid(batch)
        B = int(batch["images"].shape[0])
        metrics, out = eval_step(state, batch)
        # the tail batch's loss is already the mean over its valid rows
        # (row_weight in the loss); weighting batches by their valid rows
        # makes the reported loss a per-frame mean
        losses.append((float(metrics["loss"]), valid))
        rotmat_t = rot6d_to_rotmat(out.pose[..., 3:].reshape(B, 2, 22, 6))
        angles = _np(rotmat_to_aa(rotmat_t))
        pose, betas, rotmat = _np(out.pose), _np(out.betas), _np(rotmat_t)
        trans = pose[..., :3] / cfg.trans_scale
        rec = {
            "pred_pose0": pose[:, 0], "pred_pose1": pose[:, 1],
            "pred_angles0": angles[:, 0], "pred_angles1": angles[:, 1],
            "pred_smpltrans0": trans[:, 0], "pred_smpltrans1": trans[:, 1],
            "pred_betas0": betas[:, 0], "pred_betas1": betas[:, 1],
        }
        if save_full:
            # the per-view real focals, already in view order (real_batches);
            # the IEF init translation is the real path's fixed [0, 0, 10]
            in_t = np.tile([0, 0, 10.0], (B, 2, 1)).astype(np.float32)
            rec.update(_full_body_fields(smplx_params, rotmat, betas, trans,
                                         _np(batch["intr"]), _np(batch["focal"]), in_t,
                                         use_kernels))
            rec["in_smpltrans0"] = in_t[:, 0]
            rec["in_smpltrans1"] = in_t[:, 1]
        outputs.append({"output": {k: v[:valid] for k, v in rec.items()}})
        all_rotmat.append(rotmat[:valid])
        all_betas.append(betas[:valid])
        all_extr.append(_np(batch["extr"])[:valid])

    pred_rotmat = np.concatenate(all_rotmat)
    N = pred_rotmat.shape[0]
    if err_idcs is None:
        # default robust mask: a person detected in AT LEAST ONE view, the
        # reference's ~(person_present[0]*person_present[1]) where
        # person_present means ABSENT (err_idcs.npy overrides it). Not
        # both views: that would change crossview_consistency and break
        # parity with the reference.
        conf = ds.opose[:, :, :, 2].sum(axis=2)  # (2, n)
        err_idcs = ~((conf[0] == 0) & (conf[1] == 0))
    err_idcs = np.asarray(err_idcs)[:N]
    metrics = {
        "loss": float(np.average([l for l, _ in losses], weights=[w for _, w in losses])),
        "crossview_consistency": robust_crossview_consistency(
            smplx_params, pred_rotmat, np.concatenate(all_betas), np.concatenate(all_extr),
            err_idcs, use_kernels),
        "robust_frames": float(err_idcs.sum()),
    }
    return outputs, metrics


def compile_real_singleview(state, model, smplx_params, vposer_params, ds, batch_size: int,
                            cfg, cam: int, out_size: int = 224, int8=False,
                            int8_calib_n=8, use_kernels: bool = True, device=None,
                            mesh=None):
    """Real-data baseline (hmr) compile for ONE camera: the reference
    evaluates two hmr nets pinned to cam0/cam1 through ``first_cam`` and
    writes one outputs pkl per camera (AirPose+ reads them as the baseline
    trajectories). ``ds`` must be constructed with ``first_cam=cam`` so view
    0 is that camera. ``int8``, ``use_kernels``, ``device`` and ``mesh`` as
    in compile_twoview."""
    from ..geometry.projection import weak_cam_crop_to_full_trans
    from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
    from ..train.loop import make_real_singleview_step_fns
    from ..train.state import make_optimizer

    batches = real_batches(ds, batch_size, out_size=out_size, device=device)
    if int8:
        model, state, batches = _int8_shim(model, state, batches, int8_calib_n)
    _, eval_step = make_real_singleview_step_fns(
        model, smplx_params, vposer_params, cfg, make_optimizer(cfg.lr), "hmr_camswap_difffl",
        use_kernels=use_kernels, device=device, mesh=mesh)
    eval_step = _sharded_eval(eval_step, mesh)
    focal_full = ds.focal_pairs()[cam]

    outputs, losses = [], []
    for batch in batches:
        valid = _pop_valid(batch)
        B = int(batch["images"].shape[0])
        metrics, out = eval_step(state, batch)
        losses.append((float(metrics["loss"]), valid))
        rotmat = rot6d_to_rotmat(out.pose6d.reshape(B, 22, 6))
        # full-image translation from the crop-frame weak camera, through
        # this camera's intrinsics (the weak camera itself uses the crop
        # focal 5000)
        trans = weak_cam_crop_to_full_trans(out.cam, batch["bb"][:, 0], batch["intr"][:, 0],
                                            (5000.0, 5000.0), cfg.img_res)
        outputs.append({"output": {
            "pred_angles": _np(rotmat_to_aa(rotmat))[:valid],
            "pred_betas": _np(out.betas)[:valid],
            "pred_smpltrans": _np(trans)[:valid],
            "pred_cam": _np(out.cam)[:valid],
        }})
    return outputs, {"loss": float(np.average([l for l, _ in losses],
                                              weights=[w for _, w in losses])),
                     "camera": float(cam),
                     "focal_x": float(focal_full[0])}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _print_and_dump_metrics(metrics_by_split: Dict, path: str) -> None:
    if not is_main_rank():
        return
    for split, metrics in metrics_by_split.items():
        for k, v in metrics.items():
            print(f"{split}_{k}: {v:.4f}")
    with open(path, "w") as f:
        json.dump(metrics_by_split, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="copenet_twoview")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint file of the port's trainer (best.ckpt / last.ckpt); "
                        "any optimizer state in it is ignored")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference Lightning .ckpt, loaded with strict=True")
    p.add_argument("--datapath", default="synthetic://64")
    p.add_argument("--split", nargs="+", default=["test"], choices=("test", "train"),
                   help="on-disk splits to compile, in pkl order (the reference runs "
                        "[test, train])")
    p.add_argument("--out", default="results.pkl")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--img_res", type=int, default=224)
    p.add_argument("--synthetic_verts", type=int, default=10475,
                   help="synthetic body-model size when no --smplx_model_dir")
    p.add_argument("--save-full", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 PTQ serving configuration (any model family, "
                        "synthetic/on-disk/real paths): the quantization cost on the same "
                        "metrics")
    p.add_argument("--int8_calib_n", type=int, default=8,
                   help="activation-calibration sample size for --int8; the printed clip "
                        "rates tell whether it covered the data's activation range")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="data-parallel eval over the N ranks of torchrun --nproc-per-node N "
                        "(one card a rank): each rank evaluates its rows of every batch, "
                        "rank 0 writes the outputs (use a --batch_size divisible by N; other "
                        "batches run whole on every rank, correct but unaccelerated)")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (the CUDA card by default; raises without it)")
    p.add_argument("--smplx_model_dir", default=None)
    p.add_argument("--vposer_ckpt", default=None,
                   help="released VPoser v2 weights (torch file or npz) for the real-data "
                        "eval loss")
    p.add_argument("--first_cam", type=int, default=0, help="real:// camera pinning")
    p.add_argument("--err_idcs", default=None, help="real:// robust-frame .npy mask")
    p.add_argument("--train_frames", type=int, nargs=2, default=(0, 7000))
    p.add_argument("--test_frames", type=int, nargs=2, default=(8000, 15000))
    args = p.parse_args(argv)

    dev = resolve_device(args.platform)
    mesh = None
    if args.mesh:
        from ..parallel.launch import init_from_env
        from ..parallel.mesh import make_mesh

        dev = init_from_env(dev) or dev
        try:
            mesh = make_mesh(args.mesh)
        except ValueError as e:
            p.error(f"--mesh {args.mesh}: {e}")
        if args.batch_size % args.mesh:
            print(f"WARNING: --batch_size {args.batch_size} not divisible by --mesh "
                  f"{args.mesh}; batches will be replicated, not sharded", flush=True)

    from ..bodymodel import load_smplx_npz, synthetic_smplx_params
    from ..config import TrainConfig
    from ..data import make_synthetic_dataset
    from ..models import MODEL_REGISTRY
    from ..train.checkpoint import load_reference_state_dict
    from ..train.state import model_variables

    cfg = TrainConfig(model=args.model, batch_size=args.batch_size, img_res=args.img_res)
    if args.smplx_model_dir:
        smplx_params = load_smplx_npz(args.smplx_model_dir)
    else:
        # a 300-vertex body for synthetic://, as the JAX CLI builds
        smplx_params = synthetic_smplx_params(
            num_vertices=300 if args.datapath.startswith("synthetic")
            else args.synthetic_verts)
    smplx_params = smplx_params.to(dev)

    is_real = args.datapath.startswith(("real://", "aircap://"))
    model = MODEL_REGISTRY[args.model](iters=cfg.reg_iters)
    ckpt = args.torch_ckpt or args.ckpt
    if ckpt:
        if os.path.isdir(ckpt):
            p.error(f"{ckpt} is a directory: the port reads no orbax checkpoint; pass a .ckpt "
                    "file (airpose_tpu.train.checkpoint.export_reference_checkpoint writes "
                    "one from a JAX run)")
        blob = torch.load(ckpt, map_location="cpu", weights_only=False)
        load_reference_state_dict(model, blob, args.model)
        print(f"loaded {ckpt}"
              + (f" (step {blob['global_step']})" if "global_step" in blob else ""))
    model = model.to(dev)
    state = TrainState(step=0, **model_variables(model), opt_state=None)

    per_split = []
    metrics_by_split = {}
    kw = {"int8": args.int8, "int8_calib_n": args.int8_calib_n, "device": dev, "mesh": mesh}
    if args.datapath.startswith("synthetic://"):
        n = int(args.datapath.split("//")[1] or 64)
        data = make_synthetic_dataset(smplx_params, n, seed=7)
        splits = {"test": synthetic_batches(data, min(args.batch_size, n))}
        split_names = ["test"]
    elif args.datapath.startswith("h36m://"):
        # joints-GT metrics; --split picks the camera pair (train = cams
        # 1/2, test = 3/4)
        from ..data import H36MDataset

        if args.model not in ("copenet_twoview", "copenet_twoview_sep"):
            p.error("h36m:// eval supports the twoview families only")
        path = args.datapath[len("h36m://"):]
        for split in args.split:
            ds = H36MDataset(path, split)
            if len(ds) == 0:
                p.error(f"no frames in the h36m db under {path}")
            B = min(args.batch_size, len(ds))
            outputs, metrics = compile_h36m_twoview(
                state, model, smplx_params, h36m_batches(ds, B, args.img_res, dev), cfg, **kw)
            per_split.append(outputs)
            metrics_by_split[split] = metrics
        splits = None
    elif args.datapath.startswith("totalcap://"):
        # SMPL GT converted per batch to the synthetic contract; the
        # trainer's 80/20 splits
        from ..data import TotalCaptureDataset

        path = args.datapath[len("totalcap://"):]
        ds = TotalCaptureDataset(path)
        if len(ds) == 0:
            p.error(f"no frames in the totalcap db under {path}")
        n_train = max(1, int(len(ds) * 0.8))
        ranges = {"train": range(0, n_train), "test": range(n_train, len(ds))}
        splits = {}
        for split in args.split:
            idx = ranges[split]
            if len(idx) == 0:
                p.error(f"totalcap split '{split}' is empty ({len(ds)} frames, 80/20)")
            splits[split] = totalcap_batches(ds, smplx_params, min(args.batch_size, len(idx)),
                                             out_size=args.img_res, indices=idx, device=dev)
        split_names = args.split
    elif is_real:
        from ..bodymodel.vposer import init_vposer_params, load_vposer_ckpt
        from ..data import AircapDataset, CopenetRealDataset

        is_aircap = args.datapath.startswith("aircap://")
        path = args.datapath.split("://", 1)[1]
        if args.vposer_ckpt:
            vposer_params = load_vposer_ckpt(args.vposer_ckpt)
        else:
            print("WARNING: no --vposer_ckpt; the eval loss uses a RANDOM VPoser prior "
                  "(metrics other than the loss are unaffected)")
            vposer_params = init_vposer_params(0)
        vposer_params = vposer_params.to(dev)
        ranges = {"test": range(*args.test_frames), "train": range(*args.train_frames)}
        err = np.load(args.err_idcs) if args.err_idcs else None
        _ds_cache: Dict = {}

        def real_ds(split, first_cam):
            # the detector pkls and the calibration parse the same for both
            # camera orders (first_cam only permutes the views in
            # host_batch), so one parsed dataset serves a split
            if split not in _ds_cache:
                if is_aircap:
                    _ds_cache[split] = AircapDataset(path, drange=ranges[split],
                                                     first_cam=first_cam)
                else:
                    _ds_cache[split] = CopenetRealDataset(path, frame_range=ranges[split],
                                                          first_cam=first_cam)
            ds = _ds_cache[split]
            ds.first_cam = first_cam
            if len(ds) == 0:
                p.error(f"no frames for split '{split}' in the requested frame range "
                        "(check --test_frames/--train_frames against the capture length)")
            return ds

        if args.model == "hmr":
            # the baseline on real data: one outputs pkl PER CAMERA, suffixes
            # "0"/"1" (AirPose+ reads fname+"0" and fname+"1")
            for cam in (0, 1):
                cam_splits = []
                for split in args.split:
                    ds = real_ds(split, cam)
                    outputs, metrics = compile_real_singleview(
                        state, model, smplx_params, vposer_params, ds,
                        min(args.batch_size, len(ds)), cfg, cam, out_size=args.img_res, **kw)
                    cam_splits.append(outputs)
                    metrics_by_split[f"{split}_cam{cam}"] = metrics
                if is_main_rank():
                    with open(args.out + str(cam), "wb") as f:
                        pickle.dump(cam_splits, f)
                    print(f"wrote {args.out}{cam}")
            _print_and_dump_metrics(metrics_by_split, args.out + ".metrics.json")
            return
        for split in args.split:
            ds = real_ds(split, args.first_cam)
            outputs, metrics = compile_real_twoview(
                state, model, smplx_params, vposer_params, ds, min(args.batch_size, len(ds)),
                cfg, save_full=args.save_full, err_idcs=err, out_size=args.img_res, **kw)
            per_split.append(outputs)
            metrics_by_split[split] = metrics
        splits = None
    else:
        from ..data import AerialPeopleDataset

        splits = {}
        for split in args.split:
            ds = AerialPeopleDataset(args.datapath, split)
            if len(ds) == 0:
                p.error(f"no samples for split '{split}' under {args.datapath} (expected the "
                        "AerialPeople pkl layout with a non-empty split directory)")
            genders_to_params = None
            if args.smplx_model_dir:
                genders_to_params = {}
                for g in ("male", "female", "neutral"):
                    if os.path.exists(os.path.join(args.smplx_model_dir,
                                                   f"SMPLX_{g.upper()}.npz")):
                        genders_to_params[g] = load_smplx_npz(args.smplx_model_dir,
                                                              gender=g).to(dev)
                genders_to_params = genders_to_params or None
            ds.precompute_canonical_gt(smplx_params, genders_to_params)
            splits[split] = aerialpeople_batches(ds, min(args.batch_size, len(ds)),
                                                 out_size=args.img_res, device=dev)
        split_names = args.split

    if splits is not None:  # synthetic and on-disk supervised paths
        for split in split_names:
            if args.model in ("copenet_twoview", "copenet_twoview_sep"):
                outputs, metrics = compile_twoview(state, model, smplx_params, splits[split],
                                                   cfg, save_full=args.save_full, **kw)
            else:
                outputs, metrics = compile_singleview(state, model, smplx_params,
                                                      splits[split], cfg, args.model, **kw)
            per_split.append(outputs)
            metrics_by_split[split] = metrics

    _print_and_dump_metrics(metrics_by_split, args.out + ".metrics.json")
    if is_main_rank():
        with open(args.out, "wb") as f:
            pickle.dump(per_split, f)
        print(f"wrote {args.out} ({[len(o) for o in per_split]} batches per split)")


if __name__ == "__main__":
    main()
