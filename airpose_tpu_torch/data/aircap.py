"""AirCap (LibreCap) cross-dataset reader, the `--testdata=aircapdata`
eval path (port of airpose_tpu/data/aircap.py).

The reference reader (ref copenet/dsets/aircapData.py:29-304) depends on an
external, non-distributed module (`camera_and_NN.processCamsNNs`, imported
from a hardcoded path at `:18-20`) that wraps rosbag-extracted camera
frames, NN 2D-joint detections, and camera poses. This port defines a
self-contained on-disk layout carrying the same information and replicates
the reader's observable behavior:

  layout (per capture root):
    tstamps.npz                      {"tstamps": (N,) float64}  sync stamps
                                     (ref xsens_tstamped.npz, :39-40)
    machine_{1,2}/images/<key>.jpg   frames, key = "%.6f" % tstamp
    machine_{1,2}/joints2d.pkl       {key: (J, 3) [u, v, conf]} NN joints
    machine_{1,2}/camera.pkl         {"intr": (3,3),
                                      "extr": {key: (4,4) cam-from-world}}

  behavior replicated:
    * per sync timestamp, the closest stamped frame of each machine is
      paired (ref :46-56 get_closest_time_stamp);
    * frames kept only when BOTH machines detected a person
      (nonzero-confidence joints, ref :50-55);
    * crop window = detected-joint extent ± 50 px (ref :97-99);
    * bb encoding (crop center / principal − 1, scale) (ref :117-119).

The reader exposes the same host-batch interface as `CopenetRealDataset`,
so the aircap data flows through the real-data eval
(`eval/compile_results.py --datapath aircap://…`) unchanged — the
cross-dataset evaluation the reference ran via `--testdata=aircapdata`.
"""

import os.path as osp
import pickle
from typing import Sequence

import numpy as np

from .real import CopenetRealDataset
from .validate import DbSchemaError


def _closest(stamps: np.ndarray, t: float) -> int:
    return int(np.argmin(np.abs(stamps - t)))


def validate_aircap_layout(datapath: str) -> None:
    """Loud first-contact check of an aircap capture root (one message
    listing every missing file — same policy as the copenet_real/
    aerialpeople/h36m/totalcap hardening)."""
    if not osp.isdir(datapath):
        raise DbSchemaError(
            f"aircap: capture root '{datapath}' is not a directory")
    missing = [f for f in ("tstamps.npz",)
               if not osp.exists(osp.join(datapath, f))]
    for m in (1, 2):
        mdir = osp.join(datapath, f"machine_{m}")
        if not osp.isdir(mdir):
            missing.append(f"machine_{m}/")
            continue
        missing += [f"machine_{m}/{f}" for f in ("joints2d.pkl", "camera.pkl")
                    if not osp.exists(osp.join(mdir, f))]
    # images/ is deliberately NOT required (keypoints-only captures work,
    # same policy as validate_capture_layout)
    if missing:
        raise DbSchemaError(
            f"aircap: capture at '{datapath}' is missing {missing}; "
            f"expected tstamps.npz + machine_{{1,2}}/{{joints2d.pkl, "
            f"camera.pkl}} (+ images/ for image runs; module doc layout)")


class AircapDataset(CopenetRealDataset):
    """Self-contained AirCap capture reader. Inherits the host-batch
    assembly (context windows, keypoint crops) from CopenetRealDataset —
    only the on-disk layout and timestamp pairing differ."""

    def __init__(
        self,
        datapath: str,
        drange: Sequence[int] = None,
        first_cam: int = 0,
        context_size: int = 672,
    ):
        # deliberately NOT calling super().__init__ — different layout
        validate_aircap_layout(datapath)
        self.datapath = datapath
        self.first_cam = first_cam
        self.shuffle_cams = False
        self.context_size = context_size

        tstamps = np.load(osp.join(datapath, "tstamps.npz"))["tstamps"]

        machines = []
        for m in (1, 2):
            with open(osp.join(datapath, f"machine_{m}", "joints2d.pkl"), "rb") as f:
                joints = pickle.load(f)
            with open(osp.join(datapath, f"machine_{m}", "camera.pkl"), "rb") as f:
                cam = pickle.load(f)
            keys = sorted(joints)
            machines.append({
                "keys": keys,
                "stamps": np.asarray([float(k) for k in keys]),
                "joints": joints,
                "intr": np.asarray(cam["intr"], np.float32),
                "extr": cam["extr"],
            })

        # Pair each sync stamp with the closest frame per machine; keep the
        # pair only when both machines saw the person (ref :46-56).
        kept = []
        for t in tstamps:
            pair = [machines[m]["keys"][_closest(machines[m]["stamps"], t)]
                    for m in (0, 1)]
            if all(
                np.asarray(machines[m]["joints"][pair[m]])[:, 2].sum() > 0
                for m in (0, 1)
            ):
                kept.append(pair)
        if drange is not None:
            kept = [kept[i] for i in drange if i < len(kept)]
        self.pairs = kept
        n = len(kept)
        self.frames = list(range(n))

        self.image_paths = [
            [osp.join(datapath, f"machine_{m+1}", "images", f"{kept[i][m]}.jpg")
             for i in range(n)]
            for m in (0, 1)
        ]

        # joints in the reader's (2, N, 24, 3) SMPL-order convention
        # (padded/trimmed to 24); one detector only (the reference call
        # passes ["alphapose"], :36) — both keypoint slots carry it so
        # downstream (eval masks, AirPose+) works as-is.
        kp = np.zeros((2, n, 24, 3), np.float32)
        for m in (0, 1):
            for i in range(n):
                j = np.asarray(machines[m]["joints"][kept[i][m]], np.float32)
                k = min(24, j.shape[0])
                kp[m, i, :k] = j[:k]
        self.opose = kp
        self.apose = kp.copy()

        self.intr = np.stack([machines[m]["intr"] for m in (0, 1)])
        self.extr = np.zeros((2, n, 4, 4), np.float32)
        self.extr[..., 3, 3] = 1.0
        for m in (0, 1):
            for i in range(n):
                e = machines[m]["extr"].get(kept[i][m])
                if e is None:
                    self.extr[m, i, :3, :3] = np.eye(3)
                else:
                    self.extr[m, i] = np.asarray(e, np.float32).reshape(4, 4)

        self._probe_frame_wh()

    def focal_pairs(self):
        """Per-camera (fx, fy) from this capture's own camera.pkl intrinsics
        (the reference's aircap_cam{0,1}_FOCAL_LENGTH constants, ref
        copenet/constants.py:4-5, are just its capture's K diagonal) — NOT
        the DJI constants the parent class pins."""
        return tuple(
            (float(K[0, 0]), float(K[1, 1])) for K in self.intr
        )
