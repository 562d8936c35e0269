"""Real (DJI two-drone) dataset reader, the `copenet_real` data layout (port
of airpose_tpu/data/real.py).

On-disk format (ref copenet_real/dsets/copenet_real.py:27-266):
  machine_{1,2}/images/%06d.jpg            1920x1080 frames
  machine_{1,2}/openpose_res.pkl           {"%06d": {"pose": (1, 25, 3)}}
  machine_{1,2}/alphapose_res.json         {"%06d": {"people": [{"pose_keypoints_2d": 54}]}}
  machine_{1,2}/camera_calib.yml           cv2 FileStorage with K
  machine_{1,2}/markerposes_corrected_all.pkl  {"%06d": {"0": {rvec, tvec}}}

Behavior replicated:
  * OpenPose(25)/AlphaPose(18) remapped to the 24-joint SMPL order via the
    public index maps (`:18-19`), unmapped joints zeroed;
  * mutual-agreement gating: confidence zeroed where the two detectors
    disagree by > threshold px (`:105-106`);
  * crop window from OpenPose keypoint extent ±50 px (`:188-204`);
  * bb encoding (center/principal − 1, scale) and crop-frame keypoints
    (`:205,226-227`);
  * train = frames [0,7000), test = [8000,15000) (`:22`).

OpenCV is imported only to decode frames and to read the calib yml.
"""

import json
import os
import os.path as osp
import pickle
from typing import Dict

import numpy as np
import torch

from .. import constants as C
from ..geometry.rotations import batch_rodrigues
from .validate import DbSchemaError

# the released two-machine DJI capture layout (ref copenet_real.py:33-142)
MACHINE_FILES = ("openpose_res.pkl", "alphapose_res.json",
                 "camera_calib.yml", "markerposes_corrected_all.pkl")


def validate_capture_layout(datapath: str) -> None:
    """Loud first-contact check of a capture unpack: every machine file
    the reader needs, listed in one diagnosis instead of a bare
    FileNotFoundError on whichever file happens to load first."""
    if not osp.isdir(datapath):
        raise DbSchemaError(
            f"copenet_real: capture root '{datapath}' is not a directory")
    missing = []
    for m in (1, 2):
        mdir = osp.join(datapath, f"machine_{m}")
        if not osp.isdir(mdir):
            missing.append(f"machine_{m}/")
            continue
        missing += [f"machine_{m}/{f}" for f in MACHINE_FILES
                    if not osp.exists(osp.join(mdir, f))]
    # images/ is deliberately NOT required: keypoints-only captures are a
    # supported mode (the AirPose+ optimizer and to_hdf5 never decode
    # frames; _probe_frame_wh and host_batch tolerate absent images)
    if missing:
        raise DbSchemaError(
            f"copenet_real: capture at '{datapath}' is missing {missing}; "
            f"expected the released DJI layout machine_{{1,2}}/{{"
            f"{', '.join(MACHINE_FILES)}}} (+ images/ for image runs) "
            f"(ref copenet_real/dsets/copenet_real.py:33-142)")

# Public detector→SMPL-order joint index maps (ref copenet_real.py:18-19);
# -1 marks joints with no detector counterpart (zeroed).
OP_MAP2SMPL = np.array(
    [8, 12, 9, -1, 13, 10, -1, 14, 11, -1, 19, 22, 1, -1, -1, -1, 5, 2, 6, 3, 7, 4, -1, -1]
)
AL_MAP2SMPL = np.array(
    [-1, 11, 8, -1, 12, 9, -1, 13, 10, -1, -1, -1, 1, -1, -1, -1, 5, 2, 6, 3, 7, 4, -1, -1]
)


def _remap(kp: np.ndarray, index_map: np.ndarray) -> np.ndarray:
    out = kp[index_map]
    out[index_map == -1] = 0.0
    return out


def person_crop_box(kp: np.ndarray, frame_wh=C.IMG_SIZE):
    """Crop window from the keypoint extent ±50 px, clamped to the frame
    (ref copenet_real.py:188-204). Shared by host_batch and
    the native-client benchtest (which feeds the same box to the C++ ROI
    pipeline as a groundtruth-mode ROI message). ``frame_wh`` must be the
    capture's ACTUAL frame size (e.g. a --downsample'd prepare_real_capture
    output is 960×540): clamping at the default 1920×1080 would record a
    box wider than the decoded crop, skewing bb/context_extent — and
    diverge from the C++ ROI client, which clamps to the real frame."""
    valid = kp[:, 2] != 0
    xs = kp[valid, 0] if valid.any() else np.zeros(1)
    ys = kp[valid, 1] if valid.any() else np.zeros(1)
    xmin = max(int(xs.min()) - 50, 0)
    ymin = max(int(ys.min()) - 50, 0)
    xmax = min(int(xs.max()) + 50, frame_wh[0])
    ymax = min(int(ys.max()) + 50, frame_wh[1])
    return xmin, ymin, xmax, ymax


def load_calib_yml(path: str) -> np.ndarray:
    """Read K from a cv2 FileStorage yml."""
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    K = fs.getNode("K").mat()
    fs.release()
    return np.asarray(K, np.float32)


class CopenetRealDataset:
    """Host-side reader for the two-drone DJI capture."""

    def __init__(
        self,
        datapath: str,
        frame_range=range(0, 7000),
        first_cam: int = 0,
        shuffle_cams: bool = False,
        kp_agrmnt_threshold: float = 100.0,
        context_size: int = 672,
    ):
        validate_capture_layout(datapath)
        self.datapath = datapath
        self.frames = list(frame_range)
        self.first_cam = first_cam
        self.shuffle_cams = shuffle_cams
        self.context_size = context_size
        n = len(self.frames)

        self.image_paths = [
            [osp.join(datapath, f"machine_{m}", "images", f"{i:06d}.jpg")
             for i in self.frames]
            for m in (1, 2)
        ]

        # Actual frame size (clamp bound for person_crop_box): probe the
        # first readable frame — downsampled captures are smaller than the
        # nominal 1920×1080. Falls back to the nominal size when no frame
        # decodes (keypoints-only uses).
        self._probe_frame_wh()

        opose = np.zeros((2, n, 24, 3), np.float32)
        apose = np.zeros((2, n, 24, 3), np.float32)
        for m in (0, 1):
            op = pickle.load(
                open(osp.join(datapath, f"machine_{m+1}", "openpose_res.pkl"), "rb")
            )
            ap = json.load(
                open(osp.join(datapath, f"machine_{m+1}", "alphapose_res.json"))
            )
            for c, i in enumerate(self.frames):
                key = f"{i:06d}"
                try:
                    opose[m, c] = _remap(np.asarray(op[key]["pose"])[0], OP_MAP2SMPL)
                except Exception:
                    pass
                try:
                    kp = np.reshape(
                        ap[key]["people"][0]["pose_keypoints_2d"], (18, 3)
                    )
                    apose[m, c] = _remap(kp, AL_MAP2SMPL)
                except Exception:
                    pass

        # Mutual-agreement gating (ref :105-106).
        dist = np.sqrt(((opose[..., :2] - apose[..., :2]) ** 2).sum(-1))
        bad = dist > kp_agrmnt_threshold
        opose[..., 2] = np.where(bad, 0.0, opose[..., 2])
        apose[..., 2] = np.where(bad, 0.0, apose[..., 2])
        self.opose, self.apose = opose, apose

        self.intr = np.stack(
            [
                load_calib_yml(osp.join(datapath, f"machine_{m}", "camera_calib.yml"))
                for m in (1, 2)
            ]
        )

        # Per-frame ArUco extrinsics (ref :119-142).
        self.extr = np.zeros((2, n, 4, 4), np.float32)
        self.extr[..., 3, 3] = 1.0
        for m in (0, 1):
            poses = pickle.load(
                open(
                    osp.join(datapath, f"machine_{m+1}", "markerposes_corrected_all.pkl"),
                    "rb",
                )
            )
            for c, i in enumerate(self.frames):
                entry = poses.get(f"{i:06d}", {}).get("0")
                if entry is None:
                    self.extr[m, c, :3, :3] = np.eye(3)
                    continue
                R = batch_rodrigues(torch.from_numpy(
                    np.asarray(entry["rvec"], np.float32).reshape(1, 3)))[0].numpy()
                self.extr[m, c, :3, :3] = R
                self.extr[m, c, :3, 3] = np.asarray(entry["tvec"], np.float32).reshape(3)

    def _probe_frame_wh(self):
        """Set ``frame_wh`` from the first readable frame — downsampled
        captures are smaller than the nominal 1920×1080, and the crop-box
        clamp must match the real frame. Falls back to the nominal size
        when no frame decodes (keypoints-only uses). Shared with
        AircapDataset (same image_paths layout)."""
        import cv2

        self.frame_wh = tuple(C.IMG_SIZE)
        probe = [p for pair in list(zip(*self.image_paths))[:4] for p in pair]
        for p in probe:  # bounded: images may be absent
            img = cv2.imread(p)
            if img is not None:
                self.frame_wh = (img.shape[1], img.shape[0])
                break

    def focal_pairs(self):
        """Per-camera (fx, fy) the eval loss should project with, in
        CAMERA order (machine_1, machine_2). The DJI capture pins the
        reference's constants (ref copenet_real/constants: FOCAL_LENGTH0/1
        consumed by copenet_twoview.py:85-86) rather than the calib yml —
        kept for strict loss parity. AircapDataset overrides this with its
        own intrinsics."""
        return (C.REAL_FOCAL_LENGTH0, C.REAL_FOCAL_LENGTH1)

    def __len__(self):
        return len(self.frames)

    def keypoints(self, idx: int) -> Dict[str, np.ndarray]:
        """(op, al) 24-joint [u,v,conf] per view — the `get_j2d_only` fast
        path used by the AirPose+ optimizer (ref :260-266)."""
        return {"openpose": self.opose[:, idx], "alphapose": self.apose[:, idx]}

    def host_batch(self, indices, rng: np.random.Generator,
                   decode_images: bool = True, num_threads: int = 8) -> Dict:
        import cv2

        from .pipeline import decode_pool

        B = len(indices)
        S = self.context_size
        out = {
            "context": np.zeros((B, 2, S, S, 3), np.uint8),
            "context_extent": np.zeros((B, 2, 2), np.float32),
            "context_origin": np.zeros((B, 2, 2), np.float32),
            "context_scale": np.ones((B, 2), np.float32),
            "person_box": np.zeros((B, 2, 4), np.float32),
            "intr": np.zeros((B, 2, 3, 3), np.float32),
            "extr": np.zeros((B, 2, 4, 4), np.float32),
            "gt_j2d_conf": np.zeros((B, 2, 24, 3), np.float32),
            "gt_j2d_alpha": np.zeros((B, 2, 24, 3), np.float32),
        }
        orders = []
        for _ in indices:
            order = (0, 1)
            if self.shuffle_cams and rng.integers(2) == 1:
                order = (1, 0)
            elif self.first_cam == 1:
                order = (1, 0)
            orders.append(order)
        # frame JPEG decode on a thread pool (the role of the reference's
        # DataLoader workers; cv2.imread releases the GIL)
        decoded = {}
        if decode_images:
            jobs = [(cam, idx) for idx in indices for cam in (0, 1)]

            def _read(job):
                cam, idx = job
                return job, cv2.imread(self.image_paths[cam][idx])

            if num_threads > 1 and len(jobs) > 1:
                decoded = dict(decode_pool(num_threads).map(_read, jobs))
            else:
                decoded = dict(map(_read, jobs))

        for b, idx in enumerate(indices):
            order = orders[b]
            for v, cam in enumerate(order):
                out["intr"][b, v] = self.intr[cam]
                out["extr"][b, v] = self.extr[cam, idx]
                out["gt_j2d_conf"][b, v] = self.opose[cam, idx]
                out["gt_j2d_alpha"][b, v] = self.apose[cam, idx]

                xmin, ymin, xmax, ymax = person_crop_box(
                    self.opose[cam, idx], self.frame_wh)
                out["context_origin"][b, v] = (xmin, ymin)
                out["person_box"][b, v] = (
                    0.0, 0.0, xmax - xmin, ymax - ymin,
                )
                out["context_extent"][b, v] = (xmax - xmin, ymax - ymin)
                if decode_images:
                    # ``idx`` is positional within this split's frame list.
                    img = decoded.get((cam, idx))
                    if img is not None:
                        crop = img[ymin:ymax, xmin:xmax, ::-1]
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
