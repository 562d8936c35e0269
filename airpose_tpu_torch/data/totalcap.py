"""TotalCapture multi-view reader — the reference's totalcap loader,
modernized (port of airpose_tpu/data/totalcap.py; the canonical SMPL-X
forward runs on the device of the body model, skinning through the CUDA
kernel on the card; OpenCV is imported only when images are decoded).

The reference `totalcap_full` reads a prebuilt `dsets/totalcap_db.pkl`
({"db": [per-frame dicts with 'im1'..'im8' frame paths and SMPL GT
'poses'/'betas'/'trans']}) plus `<root>/cameras.pkl`
({'cam1'..'cam8': {'extr' (3,3), 'trans' (3,1), 'intr' (3,3)}}) and
returns all eight full frames with ×4-shrunk intrinsics
(ref copenet/src/copenet/dsets/totalcap.py:43-120). Like the h36m
loaders it is legacy-broken in the reference (pre-packaging imports,
totalcap.py:12) and outside the active path; this port reads the same
layout into the canonical two-view host-batch contract, selecting a view
pair (default cameras 1/2). TotalCapture has SMPL parameter GT: batches
carry `gt_pose_aa` / `gt_betas` / `gt_trans` passthrough (full-frame
person box — the reference consumed whole frames, no detector boxes)."""

import os.path as osp
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_FRAME_W, _FRAME_H = 1920, 1080  # ref totalcap.py:60-61 (1919/1079 crop)


class TotalCaptureDataset:
    def __init__(self, root: str, view_pair: Tuple[int, int] = (1, 2),
                 context_size: int = 672, validate: bool = True):
        from .validate import PathResolver, validate_totalcap

        self.root = root
        self.view_pair = view_pair
        self.context_size = context_size
        with open(osp.join(root, "dsets", "totalcap_db.pkl"), "rb") as f:
            self.db = pickle.load(f)["db"]
        with open(osp.join(root, "cameras.pkl"), "rb") as f:
            self.cams = pickle.load(f)
        self._resolve = PathResolver(root)
        if validate:
            # loud first-contact diagnosis: key/shape/unit drift in a real
            # totalcap_db.pkl fails here, not as a silent mis-scale
            validate_totalcap(root, self.db, self.cams, view_pair,
                              self._resolve)

    def __len__(self) -> int:
        return len(self.db)

    _canon_cache = None
    _canon_rows = None  # absolute db index → cache row

    def precompute_canonical_gt(self, smplx_params, chunk: int = 256,
                                indices: Optional[Sequence[int]] = None):
        """One-time canonical SMPL-X forward (the aerialpeople precompute
        pattern — the reference recomputed GT per sample inside DataLoader
        workers): twoview_gt_from_smpl then only composes the cheap
        per-view camera transform per batch. ``indices`` restricts the
        pass (and the (n, V, 3) vertex cache) to the frames that will
        actually be consumed — e.g. a --split test eval over the 20%
        tail."""
        sel = (list(range(len(self.db))) if indices is None
               else sorted(set(int(i) for i in indices)))
        if not sel:
            raise ValueError("no frames in the totalcap db")
        rows = [self.db[i] for i in sel]
        aa = np.stack([np.asarray(r["poses"], np.float32).ravel()
                       for r in rows])
        betas = np.stack([np.asarray(r["betas"], np.float32).ravel()[:10]
                          for r in rows])
        ow, bd, vs, js = [], [], [], []
        for s in range(0, len(sel), chunk):
            o, b, v, j = _canonical_from_params(
                aa[s:s + chunk], betas[s:s + chunk], smplx_params)
            ow.append(o)
            bd.append(b)
            vs.append(v)
            js.append(j)
        self._canon_cache = {
            "orient_w": np.concatenate(ow), "body": np.concatenate(bd),
            "vertices": np.concatenate(vs), "joints": np.concatenate(js),
        }
        self._canon_rows = {i: r for r, i in enumerate(sel)}
        return self._canon_cache

    def host_batch(self, indices: Sequence[int], rng: np.random.Generator,
                   decode_images: bool = True, swap_cams: bool = False) -> Dict:
        from .pipeline import decode_pool

        B = len(indices)
        S = self.context_size
        pose_dim = np.asarray(self.db[indices[0]]["poses"]).size
        out = {
            "context": np.zeros((B, 2, S, S, 3), np.uint8),
            "context_extent": np.zeros((B, 2, 2), np.float32),
            "context_origin": np.zeros((B, 2, 2), np.float32),
            "context_scale": np.ones((B, 2), np.float32),
            "person_box": np.zeros((B, 2, 4), np.float32),
            "intr": np.zeros((B, 2, 3, 3), np.float32),
            "extr": np.zeros((B, 2, 4, 4), np.float32),
            "gt_pose_aa": np.zeros((B, pose_dim), np.float32),
            "gt_betas": np.zeros((B, 10), np.float32),
            "gt_trans": np.zeros((B, 3), np.float32),
        }
        orders = [
            self.view_pair[::-1] if swap_cams and rng.integers(2) == 1
            else self.view_pair
            for _ in indices
        ]
        jobs, paths = [], {}
        for b, idx in enumerate(indices):
            for v, cam in enumerate(orders[b]):
                paths[(b, v)] = self._resolve(self.db[idx][f"im{cam}"])
                jobs.append((b, v))
        decoded = {}
        if decode_images:
            import cv2

            def _read(job):
                return job, cv2.imread(paths[job])

            decoded = dict(decode_pool(8).map(_read, jobs))

        for b, idx in enumerate(indices):
            rec = self.db[idx]
            out["gt_pose_aa"][b] = np.asarray(rec["poses"], np.float32).ravel()
            out["gt_betas"][b] = np.asarray(rec["betas"], np.float32).ravel()[:10]
            out["gt_trans"][b] = np.asarray(rec["trans"], np.float32).ravel()[:3]
            for v, cam in enumerate(orders[b]):
                c = self.cams[f"cam{cam}"]
                out["intr"][b, v] = np.asarray(c["intr"], np.float32)
                # cameras.pkl's (extr, trans) is the CAMERA POSE — the
                # reference feeds [extr | trans] to npPerspProj, which
                # documents it as "camera pose matrix" and inverts it
                # (extr_rot = Rᵀ, extr_trans = −Rᵀ·T, ref
                # utils/utils.py:96-107). Store the world→cam
                # [Rᵀ | −Rᵀ·T] so `extr` means the same thing as every
                # other reader's extrinsics (same convention fix as
                # data/h36m.py).
                R = np.asarray(c["extr"], np.float32)
                T = np.asarray(c["trans"], np.float32).ravel()
                extr = np.eye(4, dtype=np.float32)
                extr[:3, :3] = R.T
                extr[:3, 3] = -R.T @ T
                out["extr"][b, v] = extr
                # full-frame person box (the reference consumed whole
                # frames without boxes)
                img = decoded.get((b, v))
                H, W = ((img.shape[0], img.shape[1]) if img is not None
                        else (_FRAME_H, _FRAME_W))
                out["person_box"][b, v] = (0.0, 0.0, W, H)
                out["context_extent"][b, v] = (W, H)
                if img is not None:
                    crop = img[..., ::-1]
                    h, w = crop.shape[:2]
                    fscale = max(-(-max(h, w) // S), 1)
                    if fscale > 1:
                        crop = crop[::fscale, ::fscale]
                        h, w = crop.shape[:2]
                        out["context_scale"][b, v] = fscale
                        out["person_box"][b, v] /= fscale
                        out["context_extent"][b, v] = (w, h)
                    out["context"][b, v, :h, :w] = crop
        return out


def twoview_gt_from_smpl(hb: Dict, smplx_params, ds=None,
                         indices=None) -> Dict:
    """Augment a TotalCapture host batch with the synthetic-contract GT
    fields (gt_vertices/gt_joints/gt_pose_rotmat/gt_orient/gt_trans/gt_j2d)
    so train.losses.twoview_loss can consume it — the harness that makes
    the totalcap loader trainable (the reference shipped it legacy-broken
    and never wired it into a loss, ref copenet/dsets/totalcap.py:12).

    The SMPL world params become per-view camera-frame GT: SMPL pivots the
    root rotation about the canonical pelvis (x_w = R·(x_c − j_pelvis) +
    j_pelvis + t), so the camera-frame translation the loss composes with
    canonical joints is R_wc·(t + j_pelvis − R_root·j_pelvis) + t_wc.
    SMPL betas are used as SMPL-X betas — the shape spaces differ, so the
    per-vertex GT is approximate at the body-shape level (proven exact for
    the pose/translation composition by
    tests/test_train.py::test_totalcap_gt_matches_full_forward).

    With ``ds``+``indices`` given and ``ds.precompute_canonical_gt`` run,
    the canonical forward comes from the per-frame cache (one SMPL-X pass
    per dataset instead of per batch — the aerialpeople precompute
    pattern); only the cheap per-view camera composition runs per batch.
    gt_j2d uses the GLOBAL focal constant + per-sample principal point —
    exactly the projection twoview_loss applies to predictions
    (cam_frame_and_project, losses.py) and the aerialpeople GT convention
    (aerialpeople.py) — so the 2D supervision is consistent with the rest
    of the loss regardless of the dataset's own intrinsics."""
    from .. import constants as C

    cache = getattr(ds, "_canon_cache", None) if ds is not None else None
    rows = getattr(ds, "_canon_rows", None) if ds is not None else None
    if (cache is not None and indices is not None
            and (rows is None or all(int(i) in rows for i in indices))):
        sel = np.asarray([int(i) if rows is None else rows[int(i)]
                          for i in indices])
        orient_w = cache["orient_w"][sel]
        body = cache["body"][sel]
        verts = cache["vertices"][sel]
        joints = cache["joints"][sel]
    else:
        orient_w, body, verts, joints = _canonical_from_params(
            np.asarray(hb["gt_pose_aa"], np.float32),
            np.asarray(hb["gt_betas"], np.float32), smplx_params)

    extr = np.asarray(hb["extr"], np.float32)       # (B, 2, 4, 4) world→cam
    R_wc, t_wc = extr[:, :, :3, :3], extr[:, :, :3, 3]
    trans_w = np.asarray(hb["gt_trans"], np.float32)   # (B, 3) SMPL transl
    j_root = joints[:, 0]                              # canonical pelvis
    off = trans_w + j_root - np.einsum("bij,bj->bi", orient_w, j_root)
    orient_rel = np.einsum("bvij,bjk->bvik", R_wc, orient_w)
    trans_rel = np.einsum("bvij,bj->bvi", R_wc, off) + t_wc

    cam_j = (
        np.einsum("bvij,bkj->bvki", orient_rel, joints[:, :22])
        + trans_rel[:, :, None]
    )
    # guard degenerate depth (subject beside/behind a camera) like the
    # h36m reader; project with the loss's own convention (global focal,
    # per-sample principal)
    uv = cam_j[..., :2] / np.maximum(cam_j[..., 2:], 1e-6)
    center = np.asarray(hb["intr"], np.float32)[..., :2, 2]
    j2d = uv * np.asarray(C.FOCAL_LENGTH, np.float32) + center[:, :, None, :]

    hb = dict(hb)
    hb["gt_vertices"] = verts
    hb["gt_joints"] = joints
    hb["gt_pose_rotmat"] = body
    hb["gt_orient"] = orient_rel.astype(np.float32)
    hb["gt_trans"] = trans_rel.astype(np.float32)
    hb["gt_j2d"] = j2d.astype(np.float32)
    return hb


def _canonical_from_params(aa: np.ndarray, betas: np.ndarray, smplx_params):
    """SMPL params → (orient_w, body rotmats, canonical vertices, joints), the
    forward on the device of ``smplx_params``."""
    from ..bodymodel.smplx import smplx_forward
    from ..geometry.rotations import batch_rodrigues

    B = aa.shape[0]
    dev = smplx_params.v_template.device
    aa = torch.from_numpy(np.asarray(aa, np.float32)).to(dev)
    with torch.no_grad():
        orient_w = batch_rodrigues(aa[:, 0:3])
        body = batch_rodrigues(aa[:, 3:66].reshape(B * 21, 3)).reshape(B, 21, 3, 3)
        out = smplx_forward(
            smplx_params,
            torch.from_numpy(np.asarray(betas, np.float32)).to(dev),
            body_pose=body,
            global_orient=torch.eye(3, device=dev).expand(B, 1, 3, 3),
        )
    return (orient_w.cpu().numpy(), body.cpu().numpy(),
            out.vertices.cpu().numpy(), out.joints.cpu().numpy())
