"""Training CLI (port of airpose_tpu/train/trainer.py) — the framework's
`copenet_trainer.py` equivalent, on one CUDA device.

Replicates the reference entry point's contract (ref
copenet/copenet_trainer.py:25-94 + add_model_specific_args hparams,
copenet_twoview.py:629-684) with a typed TrainConfig underneath:

  python -m airpose_tpu_torch.train.trainer --name exp --version 1 \
      --model copenet_twoview --datapath synthetic://256 --log_dir logs \
      [--lr 5e-5 --batch_size 30 --reg_iters 3 ...] [--platform cpu]

Datapath forms:
  synthetic://N       N generated fixture samples (tests/smoke/bench)
  /path/to/aerialpeople   the reference pkl dataset layout
  h36m:///path/to/h36m   the prebuilt Human3.6M db layout (joints-only
                       supervised loss — losses.joints_loss; twoview
                       families only)
  totalcap:///path/to/totalcap   the prebuilt TotalCapture db layout
                       (SMPL parameter GT → the full supervised losses
                       via data.totalcap.twoview_gt_from_smpl; 80/20
                       train/val split)
  mixed://kind=path,kind=path   heterogeneous 50/50 mixed training over
                       two sources (aerialpeople/h36m/totalcap) — each
                       batch from one source, its loss dispatched per
                       batch (the behavior the reference's MixedDataset
                       declared but never had)
  real:///path/to/capture   the two-drone DJI capture layout
                       (data/real.py): the self-supervised fine-tune on
                       OpenPose/AlphaPose 2D keypoints and the VPoser prior
                       (--vposer_ckpt; --train_frames, --test_frames);
                       copenet_twoview[_sep], or hmr alternating the view
                       from step to step

Flags and defaults are the JAX trainer's. It differs from it in
``--platform {cpu,cuda}`` (the card by default; raises without CUDA) and in
how it goes data-parallel: under ``torchrun --nproc-per-node N`` each rank
(one card each with NCCL, or a CPU process with gloo) takes
``batch_size / N`` rows of every batch (parallel/mesh.py), where the JAX
trainer takes the largest device count that divides both batch sizes; a
world size that does not divide them is refused. Only rank 0 writes logs,
the summary grid and checkpoints, and every rank leaves with code 3
together when --time_to_run expires. Checkpoints are
``best.ckpt``/``last.ckpt`` in the reference Lightning layout with
auto-resume (train.checkpoint.CheckpointManager);
deadline-based preemption exits with code 3 (--time_to_run, same scheduler
contract as the cluster scripts); TensorBoard scalars per loss term.
"""

import argparse
import contextlib
import functools
import os
import time

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    req = p.add_argument_group("Required")
    req.add_argument("--name", required=True)
    req.add_argument("--version", required=True)
    req.add_argument("--model", required=True,
                     choices=("hmr", "muhmr", "copenet_singleview",
                              "copenet_twoview", "copenet_twoview_sep"))
    t = p.add_argument_group("Training")
    t.add_argument("--datapath", default="synthetic://64")
    t.add_argument("--log_dir", default="airpose_logs")
    t.add_argument("--lr", type=float, default=5e-5)
    t.add_argument("--batch_size", type=int, default=30)
    t.add_argument("--val_batch_size", type=int, default=30)
    t.add_argument("--max_steps", type=int, default=1000)
    t.add_argument("--val_every", type=int, default=200)
    t.add_argument("--summary_steps", type=int, default=500)
    t.add_argument("--reg_iters", type=int, default=3)
    t.add_argument("--img_res", type=int, default=224)
    t.add_argument("--time_to_run", type=float, default=None,
                   help="wall-clock budget (s); exceeded -> ckpt + exit 3")
    t.add_argument("--smpltrans_noise_sigma", type=float, default=None)
    t.add_argument("--train_reg_only", action="store_true")
    t.add_argument("--qat", action="store_true",
                   help="quantization-aware training: the train forward "
                        "sees int8-fake-quantized trunk convs (straight-"
                        "through gradient, ops/qat.py) so deployment PTQ "
                        "stays accuracy-free; combine with "
                        "--train_reg_only to adapt only the heads to a "
                        "frozen quantized trunk")
    t.add_argument("--qat_levels", type=float, default=127.0,
                   help="fake-quant grid (127 = int8 deployment)")
    t.add_argument("--qat_act", action="store_true",
                   help="with --qat: also fake-quant the trunk conv input "
                        "activations (per-tensor STE at the deployed "
                        "int8 quantization points — the recovery path "
                        "when the calibration clip-rate report shows "
                        "activation clipping)")
    t.add_argument("--qat_act_frozen", action="store_true",
                   help="with --qat_act: freeze the activation fake-quant "
                        "scales to DEPLOYMENT-CALIBRATED per-site steps "
                        "(int8_trunk.calibrate_act_scales on the "
                        "warm-started weights over the first batch) "
                        "instead of dynamic per-batch abs-max — training "
                        "sees the deployed grid exactly, clipping "
                        "included; _sep families get one table per "
                        "per-drone trunk, calibrated on its own view")
    t.add_argument("--imagenet_ckpt", default=None,
                   help="torchvision ResNet-50 .pth state dict to warm-start "
                        "the conv trunk(s) from (the reference loads ImageNet "
                        "weights non-strictly at construction, "
                        "model_copenet.py:236-238)")
    t.add_argument("--pretrained_checkpoint", default=None,
                   help="reference-layout .ckpt to initialize from (fine-tune), "
                        "e.g. another run's last.ckpt")
    t.add_argument("--smplx_model_dir", default=None,
                   help="dir with SMPLX_*.npz; synthetic body if omitted")
    t.add_argument("--body_only_verts", default=None, metavar="DIR",
                   help="directory with MANO_SMPLX_vertex_ids.pkl / "
                        "SMPL-X__FLAME_vertex_ids.npy: mask hand/face "
                        "vertices out of the vertex loss (the reference "
                        "builds this mask but never applies it, "
                        "copenet_twoview.py:67-72 — opt-in per SURVEY §2.2)")
    t.add_argument("--vposer_ckpt", default=None,
                   help="released VPoser v2 weights (torch .ckpt/.pt or npz) "
                        "— the real:// fine-tune's pose prior (ref "
                        "copenet_real/copenet_twoview.py:21-24)")
    t.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="device to train on (default: the CUDA device; "
                        "raises without one)")
    t.add_argument("--debug_nans", action="store_true",
                   help="numerical sanitizer (the reference's "
                        "autograd.detect_anomaly, ref bundle_adj.py:263): "
                        "anomaly mode pinpoints the producing op, and each "
                        "step's metrics are finite-checked with a per-term "
                        "report on failure")
    t.add_argument("--data_workers", type=int, default=4,
                   help="parallel host batch makers for the on-disk/real "
                        "training stream (the reference's 8-30 DataLoader "
                        "workers); batch order across workers is unordered")
    t.add_argument("--context_size", type=int, default=672,
                   help="host->device context window size; upload traffic "
                        "is quadratic in it (336 quarters the per-batch "
                        "transfer at the cost of crop resolution for large "
                        "windows)")
    t.add_argument("--train_frames", type=int, nargs=2, default=(0, 7000),
                   help="real:// train frame range (ref copenet_real.py:22)")
    t.add_argument("--test_frames", type=int, nargs=2, default=(8000, 15000))
    t.add_argument("--seed", type=int, default=123)
    # loss weights (reference defaults)
    for flag, default in (
        ("shape_loss_weight", 50.0), ("keypoint2d_loss_weight", 0.002),
        ("keypoint3d_loss_weight", 1.0), ("limbs3d_loss_weight", 3.0),
        ("limbstheta_loss_weight", 1.0), ("trans_loss_weight", 10.0),
        ("rootrot_loss_weight", 1.0), ("pose_loss_weight", 50.0),
        ("beta_loss_weight", 1.0),
    ):
        t.add_argument(f"--{flag}", type=float, default=default)
    return p


def make_config(args):
    from ..config import LossWeights, TrainConfig

    loss = LossWeights(
        shape=args.shape_loss_weight,
        keypoint2d=args.keypoint2d_loss_weight,
        keypoint3d=args.keypoint3d_loss_weight,
        limbs3d=args.limbs3d_loss_weight,
        limbstheta=args.limbstheta_loss_weight,
        trans=args.trans_loss_weight,
        rootrot=args.rootrot_loss_weight,
        pose=args.pose_loss_weight,
        beta=args.beta_loss_weight,
    )
    return TrainConfig(
        model=args.model, lr=args.lr, batch_size=args.batch_size,
        val_batch_size=args.val_batch_size, reg_iters=args.reg_iters,
        img_res=args.img_res,
        smpltrans_noise_sigma=args.smpltrans_noise_sigma,
        summary_steps=args.summary_steps,
        train_reg_only=args.train_reg_only, qat=args.qat,
        qat_levels=args.qat_levels, qat_act=args.qat_act,
        loss=loss, seed=args.seed,
    )


class _JsonlWriter:
    """Fallback metrics writer (one JSON object per scalar/step) when the
    optional TensorBoard writer is unavailable."""

    def __init__(self, run_dir):
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        import json

        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")
        self._f.flush()

    def add_image(self, *a, **k):
        pass

    def close(self):
        self._f.close()


class _NullWriter:
    """The writer of ranks other than 0."""

    def add_scalar(self, *a, **k):
        pass

    add_image = add_scalar

    def close(self):
        pass


def _make_writer(run_dir):
    """TensorBoard writer if its package is installed, else JSON-lines
    scalars."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(run_dir)
    except Exception:
        return _JsonlWriter(run_dir)


def _summary_grid(smplx_params, batch, rotmat2, betas2, trans2):
    """Sample-0 image summary across BOTH views: each row is
    [input crop | predicted-mesh overlay] — the visual-verification grids
    the reference logs every summary_steps (ref copenet_twoview.py:445-501).

    rotmat2 (2,22,3,3), betas2 (2,10), trans2 (2,3) are sample 0's per-view
    predictions (numpy)."""
    from ..bodymodel.smplx import smplx_forward
    from ..utils.render import overlay_mesh

    dev = smplx_params.v_template.device
    # identity-root forward + origin-pivot root composition (R·v + t) —
    # the reference's pred_vertices_cam convention (ref
    # copenet_twoview.py:282-305; root-in-model would pivot at the root
    # joint and shift the overlay by j0 − R·j0)
    with torch.no_grad():
        out = smplx_forward(
            smplx_params,
            torch.from_numpy(betas2).to(dev),
            body_pose=torch.from_numpy(rotmat2[:, 1:]).to(dev),
            global_orient=torch.eye(3, device=dev).expand(2, 1, 3, 3),
        )
    vertices = out.vertices.cpu().numpy()
    mean = np.asarray(C.IMG_NORM_MEAN)
    std = np.asarray(C.IMG_NORM_STD)
    rows = []
    for v in range(2):
        img = np.clip(batch["images"][0, v].float().cpu().numpy() * std + mean, 0, 1)
        # crop-frame weak rendering: full-image focal scaled by the crop
        # scale (per-camera focal on the real path)
        if "focal" in batch:
            base_focal = batch["focal"][v].cpu().numpy()
        else:
            base_focal = np.asarray(C.FOCAL_LENGTH)
        s = float(batch["bb"][0, v, 2])
        focal = (float(base_focal[0]) * s, float(base_focal[1]) * s)
        verts = vertices[v] @ rotmat2[v, 0].T + trans2[v]
        ov = overlay_mesh(img, verts, smplx_params.faces, focal)
        rows.append(np.concatenate([img, ov], axis=1))
    return np.concatenate(rows, axis=0).astype(np.float32)


def _twoview_summary(smplx_params, batch, preds, real: bool, trans_scale):
    """Extract sample-0 per-view (rotmat, betas, trans) from either form of
    eval_step's predictions and render the grid."""
    from ..geometry.rotations import rot6d_to_rotmat

    if real:  # FullCamOutput: pose (B, 2, 135) [scaled trans | 6D×22]
        pose = preds.pose[0].float()
        betas = preds.betas[0].float().cpu().numpy()
        trans = (pose[:, :3] / trans_scale).cpu().numpy()
        rotmat = rot6d_to_rotmat(pose[:, 3:].reshape(2, 22, 6)).cpu().numpy()
    else:
        rotmat, betas, trans = (preds[k][0].float().cpu().numpy()
                                for k in ("pred_rotmat", "pred_betas", "pred_trans"))
    return _summary_grid(smplx_params, batch, rotmat, betas, trans)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.qat_act and not args.qat:
        raise SystemExit(
            "--qat_act extends --qat with activation fake-quant; an "
            "activations-only configuration is undefined (pass --qat too)")
    dev = resolve_device(args.platform)
    from ..parallel.launch import init_from_env

    dev = init_from_env(dev) or dev
    anomaly = (torch.autograd.detect_anomaly() if args.debug_nans
               else contextlib.nullcontext())
    with anomaly:
        _train(args, dev)


def _train(args, dev: torch.device):
    from ..bodymodel import load_smplx_npz, synthetic_smplx_params
    from ..data import make_synthetic_dataset
    from ..data.pipeline import Prefetcher, finish_batch
    from ..models import MODEL_REGISTRY
    from ..parallel.mesh import all_reduce_sum, make_mesh, shard_batch
    from . import losses
    from .checkpoint import CheckpointManager
    from .elastic import CHECKPOINT_EXIT_CODE, DeadlineGuard
    from .loop import make_singleview_step_fns, make_twoview_step_fns
    from .state import create_train_state

    cfg = make_config(args)
    run_dir = os.path.join(args.log_dir, args.name, f"version_{args.version}")
    os.makedirs(run_dir, exist_ok=True)

    # ---- data parallel over the torchrun group, if there is one ----
    mesh = make_mesh() if torch.distributed.is_initialized() else None
    if mesh is not None and (cfg.batch_size % mesh.n_data or cfg.val_batch_size % mesh.n_data):
        raise SystemExit(
            f"{mesh.n_data} ranks do not divide --batch_size {cfg.batch_size} and "
            f"--val_batch_size {cfg.val_batch_size}: each rank takes an equal share "
            "of every batch")
    main_rank = mesh is None or mesh.data_rank == 0

    # ---- body model ----
    genders_to_params = None
    if args.smplx_model_dir:
        smplx_params = load_smplx_npz(args.smplx_model_dir, gender="neutral") \
            if os.path.exists(os.path.join(args.smplx_model_dir, "SMPLX_NEUTRAL.npz")) \
            else load_smplx_npz(args.smplx_model_dir)
        smplx_params = smplx_params.to(dev)
        # gendered GT (the reference runs gendered SMPL-X per sample,
        # aerialpeople.py:180-197)
        genders_to_params = {}
        for g in ("male", "female", "neutral"):
            p = os.path.join(args.smplx_model_dir, f"SMPLX_{g.upper()}.npz")
            if os.path.exists(p):
                genders_to_params[g] = load_smplx_npz(args.smplx_model_dir, gender=g).to(dev)
        if not genders_to_params:
            genders_to_params = None
    else:
        small = args.datapath.startswith("synthetic://")
        smplx_params = synthetic_smplx_params(
            num_vertices=300 if small else 10475
        ).to(dev)

    # ---- data ----
    real_finetune = args.datapath.startswith("real://")
    sources = None          # supervised on-disk source list (set below)
    source_loss_kinds = []  # per-source loss kind ("smpl" | "joints")
    source_names = []       # per-source kind label for metric reporting
    if args.datapath.startswith("synthetic://"):
        n = int(args.datapath.split("//")[1] or 64)
        data = make_synthetic_dataset(
            smplx_params, n, seed=cfg.seed, img_size=cfg.img_res
        )
        n_train = max(1, int(n * 0.8))

        def train_batches():
            rng = np.random.default_rng(cfg.seed)
            while True:
                idx = torch.from_numpy(rng.integers(0, n_train, size=cfg.batch_size))
                yield {k: v[idx] for k, v in data.items()}

        def val_batches():
            for s in range(n_train, n - cfg.val_batch_size + 1, cfg.val_batch_size):
                yield {k: v[s : s + cfg.val_batch_size] for k, v in data.items()}
            if n - n_train < cfg.val_batch_size:
                yield {k: v[n_train:] for k, v in data.items()}
    elif real_finetune:
        # Real DJI layout: self-supervised fine-tune (OpenPose/AlphaPose 2D
        # + VPoser prior; ref copenet_real/copenet_trainer.py).
        from ..data import CopenetRealDataset

        path = args.datapath[len("real://"):]
        # fixed camera order: the per-view focal lengths differ (the
        # reference also trains the real twoview with shuffle_cams=False)
        train_ds = CopenetRealDataset(
            path, frame_range=range(*args.train_frames), shuffle_cams=False,
            context_size=args.context_size)
        test_ds = CopenetRealDataset(path, frame_range=range(*args.test_frames),
                                     context_size=args.context_size)
        print(f"loaded {len(train_ds)} train / {len(test_ds)} test frames")
        # per-camera focal lengths (ref copenet_real/constants.py:12-13, used
        # by the real loss's projection, copenet_twoview.py:300-306)
        focal = torch.tensor([C.REAL_FOCAL_LENGTH0, C.REAL_FOCAL_LENGTH1], device=dev)

        def _finish_real(ds, idx, rng_np):
            b = finish_batch(ds.host_batch(idx, rng_np), None, deterministic=True, margin=0.0,
                             out_size=cfg.img_res, device=dev)
            b["gt_j2d_conf"] = b["gt_j2d_conf"][:, :, :22]
            b["focal"] = focal
            return b

        def train_batches():
            # per-worker deterministic streams; interleaving is unordered
            # (the training stream is random sampling anyway)
            worker_rng = {}

            def make_batch(wid):
                rng_np = worker_rng.setdefault(wid, np.random.default_rng(cfg.seed + wid))
                idx = rng_np.integers(0, len(train_ds), size=cfg.batch_size)
                return _finish_real(train_ds, idx, rng_np)

            return Prefetcher.from_factory(
                make_batch, num_workers=max(1, args.data_workers), device=dev)

        def val_batches():
            rng_np = np.random.default_rng(cfg.seed)
            bs = min(cfg.val_batch_size, len(test_ds))
            for s in range(0, min(len(test_ds), 4 * bs) - bs + 1, bs):
                yield _finish_real(test_ds, list(range(s, s + bs)), rng_np)
    else:
        # Supervised on-disk families — ONE source factory shared by the
        # standalone aerialpeople / h36m:// / totalcap:// paths AND
        # mixed://. A "source" is (fin_train, n_train, fin_val, n_val,
        # loss_kind); mixed:// simply runs two of them with the declared
        # 50/50 draw (ref dsets/mixed_dataset.py:19-29 — which the
        # reference never actually did: legacy-broken imports AND
        # `np.random.rand(1) < 2` always returns dataset[0]). Every batch
        # carries a source tag; the loop dispatches the source's
        # supervised loss (SMPL-GT → twoview_loss, joints-GT →
        # joints_loss) over ONE TrainState.
        if args.datapath.startswith("mixed://"):
            spec = args.datapath[len("mixed://"):]
            pairs = [kv.split("=", 1) for kv in spec.split(",")]
            if len(pairs) != 2 or any(len(kv) != 2 for kv in pairs):
                raise SystemExit(
                    "mixed:// expects exactly two kind=path sources, "
                    "e.g. mixed://h36m=/d/h36m,aerialpeople=/d/aerial")
        elif args.datapath.startswith("h36m://"):
            pairs = [("h36m", args.datapath[len("h36m://"):])]
        elif args.datapath.startswith("totalcap://"):
            pairs = [("totalcap", args.datapath[len("totalcap://"):])]
        else:
            # plain path = the reference pkl AerialPeople layout
            pairs = [("aerialpeople", args.datapath)]

        def _finish(hb, gen, det):
            return finish_batch(hb, gen, deterministic=det, out_size=cfg.img_res, device=dev)

        def _build_source(kind, path):
            """→ (fin_train(idx,rng,gen), n_train, fin_val(idx,rng,gen),
            n_val, loss_kind). fin_* indices are 0-based positions within
            the split; ``gen`` is a torch.Generator on the device."""
            if kind == "h36m":
                # joints-only GT (losses.joints_loss); the reference
                # shipped these loaders legacy-broken and never wired
                # them into a loss (ref copenet/dsets/h36m.py:12-15)
                from ..data.h36m import H36MDataset

                tr = H36MDataset(path, "train",
                                 context_size=args.context_size)
                te = H36MDataset(path, "test",
                                 context_size=args.context_size)

                def _fin(ds, idx, rng_np, det, gen):
                    return _finish(ds.host_batch(idx, rng_np, swap_cams=not det), gen, det)

                def fin_train(idx, rng_np, gen):
                    return _fin(tr, idx, rng_np, False, gen)

                def fin_val(idx, rng_np, gen):
                    return _fin(te, idx, rng_np, True, gen)

                return fin_train, len(tr), fin_val, len(te), "joints"
            if kind == "totalcap":
                # SMPL parameter GT → the synthetic twoview contract
                # (twoview_gt_from_smpl; canonical forward precomputed
                # once over the db, the aerialpeople pattern); 80/20
                # train/val split (ref copenet/dsets/totalcap.py:12 is
                # equally legacy-broken)
                from ..data.totalcap import (TotalCaptureDataset,
                                             twoview_gt_from_smpl)

                ds = TotalCaptureDataset(path,
                                         context_size=args.context_size)
                if len(ds) < 2:
                    raise SystemExit(
                        f"totalcap db under {path} has {len(ds)} frames; "
                        "the 80/20 train/val split needs at least 2")
                ds.precompute_canonical_gt(smplx_params)
                n_tr = max(1, int(len(ds) * 0.8))

                def _fin(abs_idx, rng_np, det, gen):
                    hb = ds.host_batch(abs_idx, rng_np, swap_cams=not det)
                    hb = twoview_gt_from_smpl(hb, smplx_params, ds=ds,
                                              indices=abs_idx)
                    return _finish(hb, gen, det)

                def fin_train(idx, rng_np, gen):
                    return _fin(list(idx), rng_np, False, gen)

                def fin_val(idx, rng_np, gen):
                    return _fin([n_tr + i for i in idx], rng_np, True, gen)

                return fin_train, n_tr, fin_val, len(ds) - n_tr, "smpl"
            if kind == "aerialpeople":
                from ..data import AerialPeopleDataset

                tr = AerialPeopleDataset(path, "train",
                                         context_size=args.context_size)
                te = AerialPeopleDataset(path, "test",
                                         context_size=args.context_size)
                if len(tr) == 0 or len(te) == 0:
                    raise SystemExit(
                        f"no samples under {path} (expected the "
                        "AerialPeople pkl layout)")
                tr.precompute_canonical_gt(smplx_params, genders_to_params)
                te.precompute_canonical_gt(smplx_params, genders_to_params)

                def _fin(ds, idx, rng_np, det, gen):
                    hb = ds.host_batch(idx, rng_np, swap_cams=not det)
                    gt = ds.canonical_gt(idx)  # cached canonical GT
                    hb["gt_vertices"] = gt["vertices"]
                    hb["gt_joints"] = gt["joints"]
                    hb["gt_j2d"] = hb["gt_j2d"][:, :, :22]
                    return _finish(hb, gen, det)

                def fin_train(idx, rng_np, gen):
                    return _fin(tr, idx, rng_np, False, gen)

                def fin_val(idx, rng_np, gen):
                    return _fin(te, idx, rng_np, True, gen)

                return fin_train, len(tr), fin_val, len(te), "smpl"
            raise SystemExit(f"unknown data source kind '{kind}' "
                             "(aerialpeople, h36m, totalcap)")

        sources = [_build_source(k, pth) for k, pth in pairs]
        source_loss_kinds = [s[4] for s in sources]
        source_names = [k for k, _ in pairs]
        for (k, pth), s in zip(pairs, sources):
            if s[1] == 0 or s[3] == 0:
                # fail fast: an empty split would otherwise surface as a
                # range(step=0) ValueError at the first val epoch
                raise SystemExit(
                    f"source {k}={pth} has {s[1]} train / {s[3]} val "
                    "frames; need at least 1 of each")
        print("data sources: " + ", ".join(
            f"{k}({s[1]} train/{s[3]} val, {s[4]} loss)"
            for (k, _), s in zip(pairs, sources)))

        def train_batches():
            # parallel host batch makers overlapped with the train step
            # (the reference's 8-30 DataLoader workers,
            # copenet_twoview.py:427-443); per-worker deterministic
            # streams, unordered interleaving
            from ..data.mixed import mixed_draw

            worker_state = {}

            def make_batch(wid):
                if wid not in worker_state:
                    worker_state[wid] = (
                        np.random.default_rng(cfg.seed + wid),
                        torch.Generator(device=dev).manual_seed(cfg.seed + 1000 + wid),
                    )
                rng_np, gen = worker_state[wid]
                s = 0 if len(sources) == 1 else mixed_draw(rng_np)
                fin_train, n_tr = sources[s][0], sources[s][1]
                idx = rng_np.integers(0, n_tr, size=cfg.batch_size)
                b = fin_train(idx, rng_np, gen)
                b["mixed_source"] = np.full(cfg.batch_size, s, np.int32)
                return b

            # the dispatch tag stays host-side: the step dispatcher reads
            # it every step, and a device tag would cost a blocking
            # device→host read per step
            return Prefetcher.from_factory(
                make_batch, num_workers=max(1, args.data_workers), device=dev,
                host_keys=("mixed_source",))

        def val_batches():
            rng_np = np.random.default_rng(cfg.seed)
            for s, src in enumerate(sources):
                _, _, fin_val, n_val, _ = src
                bs = min(cfg.val_batch_size, n_val)
                for st in range(0, n_val - bs + 1, bs):
                    b = fin_val(list(range(st, st + bs)), rng_np, None)
                    b["mixed_source"] = np.full(bs, s, np.int32)
                    yield b

    # ---- model + steps ----
    model_cls = MODEL_REGISTRY[cfg.model]
    model = model_cls(iters=cfg.reg_iters, dtype=torch.bfloat16, seed=cfg.seed,
                      act_fq=cfg.qat_levels if cfg.qat_act else None).to(dev)
    it = train_batches()  # one iterator: shared by the calibration probe and the loop
    # Everything below consumes `it`; the finally closes a Prefetcher's
    # daemon workers (they park forever in the bounded put otherwise —
    # in-process callers would leak them plus their queued device-resident
    # batches on every train run).
    writer = None
    try:
        sample = next(it)
        state, tx = create_train_state(model, cfg.lr, train_reg_only=cfg.train_reg_only)

        # ---- warm starts (BEFORE the step fns: --qat_act_frozen below
        # calibrates activation scales on the warm-started weights, the
        # same procedure deployment calibration runs on a trained ckpt) --
        if args.imagenet_ckpt:
            from .checkpoint import load_imagenet_resnet50, warm_start_trunks

            trunk = load_imagenet_resnet50(args.imagenet_ckpt)
            warm_start_trunks(state.params, state.batch_stats, trunk, cfg.model)
            print(f"warm-started trunk(s) from {args.imagenet_ckpt}")
        if args.pretrained_checkpoint:
            # Warm start takes params + batch stats only; step counter and
            # optimizer state stay fresh (a --train_reg_only fine-tune's
            # optimizer differs from the pretrain's).
            from .checkpoint import load_model_variables

            path = os.path.abspath(args.pretrained_checkpoint)
            kind = "ckpt" if os.path.isdir(path) else "torch_ckpt"
            try:
                _, restored = load_model_variables(cfg.model, device=dev, **{kind: path})
            except RuntimeError:  # the strict load: another family's state dict
                restored = None
            if restored is None:
                raise SystemExit(
                    f"--pretrained_checkpoint {path} holds a different "
                    f"param tree than --model {cfg.model} — wrong model "
                    "family for this warm start")
            with torch.no_grad():
                for tree in ("params", "batch_stats"):
                    for name, t in getattr(state, tree).items():
                        t.copy_(restored[tree][name])
            print(f"warm-started from {path} ({kind})")

        if args.qat_act_frozen:
            # Frozen calibrated activation scales: train through the
            # DEPLOYED grid (static per-site steps, clipping included)
            # instead of dynamic per-batch abs-max — closes the
            # train/deploy scale mismatch of plain --qat_act. Calibration
            # mirrors deployment (int8_trunk.calibrate_act_scales on the
            # current weights over the first batch's crops).
            if not cfg.qat_act:
                raise SystemExit("--qat_act_frozen requires --qat_act")
            from ..ops.int8_trunk import (calibrate_act_scales,
                                          quantize_trunk_params)

            imgs = sample["images"]
            with torch.no_grad():
                if hasattr(model, "trunk"):  # shared trunk: fold views
                    flat = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
                    table = calibrate_act_scales(
                        quantize_trunk_params(model.trunk.state_dict()), flat)
                    act_fq = (cfg.qat_levels, table)
                    n_sites, n_crops = len(table), flat.shape[0]
                else:  # _sep: each per-drone trunk calibrates on ITS view
                    tabs = tuple(
                        calibrate_act_scales(
                            quantize_trunk_params(getattr(model, tk).state_dict()), imgs[:, v])
                        for v, tk in enumerate(("trunk0", "trunk1")))
                    act_fq = (cfg.qat_levels, tabs)
                    n_sites = sum(len(t) for t in tabs)
                    n_crops = imgs.shape[0] * 2
            frozen = model_cls(iters=cfg.reg_iters, dtype=torch.bfloat16, seed=cfg.seed,
                               act_fq=act_fq).to(dev)
            frozen.load_state_dict(model.state_dict())
            model = frozen
            state, tx = create_train_state(model, cfg.lr, train_reg_only=cfg.train_reg_only)
            print(f"frozen activation-QAT: {n_sites} per-site scales "
                  f"calibrated on {n_crops} crops")

        vmask = None
        if args.body_only_verts:
            from ..bodymodel.vertex_ids import load_body_vertex_mask

            vmask = torch.from_numpy(load_body_vertex_mask(
                args.body_only_verts, smplx_params.v_template.shape[0])).to(dev)
            print(f"body-only vertex loss: {int((vmask == 0).sum())} hand/face "
                  f"vertices masked of {vmask.shape[0]}")
            if real_finetune:
                raise SystemExit(
                    "--body_only_verts applies to the supervised vertex loss; "
                    "the real:// self-supervised objective has no vertex term")
            if sources is not None and "smpl" not in source_loss_kinds:
                raise SystemExit(
                    "--body_only_verts applies to the supervised vertex loss; "
                    "none of the given sources has a vertex term (joints-only "
                    "GT such as h36m:// uses joints_loss)")
        if real_finetune:
            from ..bodymodel import init_vposer_params, load_vposer_ckpt
            from .loop import make_real_singleview_step_fns, make_real_twoview_step_fns

            if args.vposer_ckpt:
                vposer_params = load_vposer_ckpt(args.vposer_ckpt).to(dev)
                print(f"loaded VPoser prior from {args.vposer_ckpt}")
            else:
                # A randomly-initialized VAE is NOT a pose prior — fine-tuning
                # against it regularizes toward noise. Kept only so tests and
                # smoke runs work without the released weights. Seed 0, the
                # placeholder prior the JAX package's eval also builds.
                print("WARNING: no --vposer_ckpt given; using a RANDOM VPoser "
                      "prior. Real fine-tuning results will be meaningless — "
                      "pass the released V02_05 snapshot for the reference's "
                      "self-supervised objective.", flush=True)
                vposer_params = init_vposer_params(0).to(dev)
            if cfg.model in ("copenet_twoview", "copenet_twoview_sep"):
                train_step, eval_step = make_real_twoview_step_fns(
                    model, smplx_params, vposer_params, cfg, tx, device=dev, mesh=mesh)
            elif cfg.model == "hmr":
                # the real trainer's --model=hmr alias is the camera-swapped
                # variant (ref copenet_real/copenet_trainer.py:32-38): the view
                # alternates per step (the "camswap" training regime)
                view_step, eval_step = make_real_singleview_step_fns(
                    model, smplx_params, vposer_params, cfg, tx, "hmr_camswap_difffl",
                    device=dev, mesh=mesh)
                steps_taken = [0]

                def train_step(state, batch, gen):
                    view = steps_taken[0] % 2
                    steps_taken[0] += 1
                    return view_step(state, batch, gen, view)
            else:
                raise SystemExit(
                    f"--model {cfg.model} has no real:// fine-tune path "
                    "(use copenet_twoview[_sep] or hmr)")
        elif cfg.model in ("copenet_twoview", "copenet_twoview_sep"):
            smpl_loss = None if vmask is None else functools.partial(
                losses.twoview_loss, vertex_mask=vmask)
            if sources is not None:
                # one step-fn pair per loss kind present, dispatched host-side
                # on the batch's source tag over ONE TrainState
                # (single-source runs dispatch trivially)
                by_kind = {"smpl": make_twoview_step_fns(
                    model, smplx_params, cfg, tx, loss=smpl_loss, device=dev, mesh=mesh)}
                if "joints" in source_loss_kinds:
                    by_kind["joints"] = make_twoview_step_fns(
                        model, smplx_params, cfg, tx, loss=losses.joints_loss, device=dev,
                        mesh=mesh)

                def _src(batch):
                    return int(np.asarray(batch.pop("mixed_source"))[0])

                def train_step(state, batch, gen):
                    kind = source_loss_kinds[_src(batch)]
                    return by_kind[kind][0](state, batch, gen)

                def eval_step(state, batch):
                    kind = source_loss_kinds[_src(batch)]
                    return by_kind[kind][1](state, batch)
            else:  # synthetic:// supervised path (untagged batches)
                train_step, eval_step = make_twoview_step_fns(
                    model, smplx_params, cfg, tx, loss=smpl_loss, device=dev, mesh=mesh)
        elif sources is not None and "joints" in source_loss_kinds:
            raise SystemExit(
                f"--model {cfg.model} has no joints-GT path "
                "(use copenet_twoview[_sep])"
            )
        else:
            base_train, base_eval = make_singleview_step_fns(
                model, smplx_params, cfg, tx, cfg.model, vertex_mask=vmask, device=dev,
                mesh=mesh)
            if sources is not None:  # on-disk batches carry the source tag

                def train_step(state, batch, gen):
                    batch.pop("mixed_source")
                    return base_train(state, batch, gen)

                def eval_step(state, batch):
                    batch.pop("mixed_source")
                    return base_eval(state, batch)
            else:
                train_step, eval_step = base_train, base_eval

        # ---- checkpoints: resume ----
        ckpts = CheckpointManager(os.path.join(run_dir, "checkpoints"), cfg.model)
        state = ckpts.auto_resume(state)
        start_step = state.step

        # ---- logging (rank 0) ----
        writer = _make_writer(run_dir) if main_rank else _NullWriter()
        guard = DeadlineGuard(args.time_to_run)
        # the step's draws (dropout, translation noise) replay from the seed
        # on every start, resumed or not, as the JAX trainer's key does; one
        # generator a rank
        rank = 0 if mesh is None else mesh.data_rank
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + rank)

        def save(name=None, val_loss=None):
            """Rank 0 writes; the others wait until it has."""
            if main_rank:
                if val_loss is None:
                    ckpts.save(state, name)
                else:
                    ckpts.save_with_val(state, val_loss)
            if mesh is not None:
                torch.distributed.barrier()

        def expired():
            """The deadline, agreed by every rank (any rank's clock)."""
            flag = torch.tensor([float(guard.expired())], device=dev)
            return bool(all_reduce_sum(flag, mesh.group) > 0) if mesh is not None else bool(flag)

        t_last = time.perf_counter()
        pending = [sample]
        for step in range(start_step, args.max_steps):
            batch = pending.pop() if pending else next(it)
            # the dispatch tag never rides to the device: the step
            # dispatcher pops it host-side every step
            tag = batch.pop("mixed_source", None)
            batch = shard_batch({k: v.to(dev) for k, v in batch.items()}, mesh)
            if tag is not None:
                batch["mixed_source"] = np.asarray(tag)
            state, metrics = train_step(state, batch, gen)

            if args.debug_nans:
                m = {k: float(v) for k, v in metrics.items()}
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad:
                    # per-term report, the detect_anomaly-style diagnosis
                    print(f"NON-FINITE at step {step}: {bad}; all terms: {m}",
                          flush=True)
                    norms = {name: float(t.detach().float().norm())
                             for name, t in list(state.params.items())[:20]}
                    print(f"param norms (first 20 leaves): {norms}", flush=True)
                    raise FloatingPointError(f"non-finite loss terms: {bad}")

            if (step + 1) % 10 == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                dt = (time.perf_counter() - t_last)
                t_last = time.perf_counter()
                for k, v in m.items():
                    writer.add_scalar(f"{k}/train", v, step)
                if main_rank:
                    print(f"step {step + 1} loss {m['loss']:.2f} ({dt:.2f}s/10 steps)",
                          flush=True)

            if (step + 1) % args.val_every == 0 or step + 1 == args.max_steps:
                vals = []
                vals_by_src = {}
                summary_done = False
                for vb in val_batches():
                    src = (int(np.asarray(vb["mixed_source"])[0])
                           if "mixed_source" in vb else None)
                    vtag = vb.pop("mixed_source", None)
                    vb = shard_batch({k: v.to(dev) for k, v in vb.items()}, mesh)
                    if vtag is not None:
                        vb["mixed_source"] = np.asarray(vtag)
                    vm, preds = eval_step(state, vb)
                    vals.append({k: float(v) for k, v in vm.items()})
                    if src is not None:
                        vals_by_src.setdefault(src, []).append(vals[-1])
                    if main_rank and not summary_done and cfg.model in (
                        "copenet_twoview", "copenet_twoview_sep"
                    ):
                        # rendered per-view [input | pred] grid summary (the
                        # reference's TB summaries, copenet_twoview.py:445-501),
                        # incl. the real fine-tune path where visuals are the
                        # only verification signal
                        try:
                            img = _twoview_summary(smplx_params, vb, preds, real_finetune,
                                                   cfg.trans_scale)
                            writer.add_image(
                                "val_pred_shape_cam", img.transpose(2, 0, 1), step
                            )
                        except Exception as e:  # rendering is best-effort
                            print(f"summary render skipped: {e}", flush=True)
                        summary_done = True
                # mixed:// val batches carry per-source metric sets — average
                # each key over the entries that have it
                keys = sorted(set().union(*vals))
                mean_val = {
                    k: float(np.mean([v[k] for v in vals if k in v]))
                    for k in keys
                }
                for k, v in mean_val.items():
                    writer.add_scalar(f"{k}/val", v, step)
                per_src = ""
                if len(vals_by_src) > 1:
                    # heterogeneous (mixed://) val: the combined mean averages
                    # DIFFERENT loss kinds across sources — also report each
                    # source's own mean so progress per dataset is readable
                    def _sname(s):
                        n = source_names[s]
                        return f"{n}{s}" if source_names.count(n) > 1 else n

                    for s, lst in sorted(vals_by_src.items()):
                        name = _sname(s)
                        for k in sorted(set().union(*lst)):
                            writer.add_scalar(
                                f"{k}/val_{name}",
                                float(np.mean([v[k] for v in lst if k in v])),
                                step)
                    per_src = " (" + ", ".join(
                        f"{_sname(s)} "
                        f"{np.mean([v['loss'] for v in lst]):.2f}"
                        for s, lst in sorted(vals_by_src.items())) + ")"
                if main_rank:
                    print(f"step {step + 1} val_loss {mean_val['loss']:.2f}"
                          f"{per_src}", flush=True)
                save(val_loss=mean_val["loss"])

            if expired():
                if main_rank:
                    print("time_to_run exceeded: checkpoint + exit 3", flush=True)
                save("last")
                raise SystemExit(CHECKPOINT_EXIT_CODE)

        save("last")
        if main_rank:
            print("training done", flush=True)
    finally:
        # Close the writer on EVERY exit (exceptions, the DeadlineGuard's
        # SystemExit) so buffered TensorBoard events are flushed, not just
        # on clean completion. `writer` is None if the failure precedes
        # its creation.
        if writer is not None:
            writer.close()
        close = getattr(it, "close", None)
        if close is not None:
            close()


if __name__ == "__main__":
    main()
