"""Synthetic Human3.6M / TotalCapture prebuilt-db generators (port of
airpose_tpu/tools/synth_mocap_dbs.py; numpy and OpenCV, h5py for H36M's
cameras, the same files from the same seed).

The reference consumes PREBUILT databases for these datasets
(`dsets/h36m_db.pkl` + `dsets/h36m_cameras.h5`, ref
copenet/src/copenet/dsets/h36m.py:24-60; `dsets/totalcap_db.pkl` +
`cameras.pkl`, ref copenet/src/copenet/dsets/totalcap.py:43-80) whose
construction scripts are not in the tree. These writers generate tiny
schema-identical databases so the h36m:// / totalcap:// / mixed:// train
and eval paths are exercisable end to end without the licensed datasets —
the same role tools/synth_real_capture.py plays for the DJI layout.

Cameras are deliberately NON-trivial (off-axis, looking at the subject) in
the conventions the reference's own projection code documents
(ref utils/utils.py:96-107 npPerspProj: stored (R, T) is the CAMERA POSE;
world→cam is x·R − T·R): an identity-convention reader projects garbage on
these fixtures, which is exactly what the convention-lock tests check.

Usage:
  python -m airpose_tpu_torch.tools.synth_mocap_dbs --kind h36m --out /d/h36m -n 8

``--kind h36m`` needs h5py, which is imported where it writes the cameras.
"""

import argparse
import os
import os.path as osp
import pickle

import numpy as np


def _look_at(T: np.ndarray, subject: np.ndarray) -> np.ndarray:
    """Camera rotation whose third COLUMN is the view direction (the
    camera-pose convention npPerspProj inverts)."""
    z = subject - T
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def write_h36m(root: str, n: int = 3, seed: int = 2,
               img_size: int = 1002) -> str:
    """Write the dsets/h36m_db.pkl + dsets/h36m_cameras.h5 + frames layout
    (GT in world mm; cameras store T = camera center in mm)."""
    import cv2
    import h5py

    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "dsets"), exist_ok=True)
    os.makedirs(osp.join(root, "frames"), exist_ok=True)
    db = []
    for i in range(n):
        rec = {"s": "1", "gt": (rng.normal(0, 300, (32, 3))
                                + np.asarray([0, 0, 4000.0])).ravel()}
        for cam in (1, 2, 3, 4):
            p = osp.join("frames", f"{i:03d}_c{cam}.jpg")
            img = (rng.random((img_size, img_size, 3)) * 255).astype(np.uint8)
            cv2.imwrite(osp.join(root, p), img)
            rec[f"c{cam}"] = p
        db.append(rec)
    with open(osp.join(root, "dsets", "h36m_db.pkl"), "wb") as f:
        pickle.dump(db, f)
    with h5py.File(osp.join(root, "dsets", "h36m_cameras.h5"), "w") as h5:
        g = h5.create_group("subject1")
        subject = np.asarray([0.0, 0.0, 4000.0])  # mm, fixture GT center
        for cam in (1, 2, 3, 4):
            c = g.create_group(f"camera{cam}")
            T = np.asarray([400.0 * cam, -300.0, 500.0])
            c["R"] = _look_at(T, subject)
            c["T"] = T.reshape(3, 1)
            c["f"] = np.full((2, 1), 1100.0)
            c["c"] = np.asarray([[img_size / 2.0], [img_size / 2.0]])
    return root


def write_totalcap(root: str, n: int = 2, seed: int = 4,
                   frame_wh=(480, 270)) -> str:
    """Write the dsets/totalcap_db.pkl + cameras.pkl + frames layout
    (SMPL parameter GT in world meters; 8 ring cameras storing the camera
    POSE, which the reader inverts to world→cam)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "dsets"), exist_ok=True)
    os.makedirs(osp.join(root, "frames"), exist_ok=True)
    W, H = frame_wh
    db = []
    for i in range(n):
        rec = {"poses": rng.normal(0, 0.3, 72).astype(np.float32),
               "betas": rng.normal(0, 1, 10).astype(np.float32),
               "trans": np.asarray([0.1, 0.2, 3.0], np.float32)}
        for cam in range(1, 9):
            p = osp.join("frames", f"{i:03d}_cam{cam}.jpg")
            img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
            cv2.imwrite(osp.join(root, p), img)
            rec[f"im{cam}"] = p
        db.append(rec)
    with open(osp.join(root, "dsets", "totalcap_db.pkl"), "wb") as f:
        pickle.dump({"db": db}, f)
    subject = np.asarray([0.1, 0.2, 3.0])
    cams = {}
    for c in range(1, 9):
        a = 2 * np.pi * c / 8
        T = subject + 4.0 * np.asarray([np.sin(a), 0.1, np.cos(a)])
        cams[f"cam{c}"] = {
            "extr": _look_at(T, subject),
            "trans": T.reshape(3, 1),
            "intr": np.asarray([[500.0, 0, W / 2.0],
                                [0, 500.0, H / 2.0], [0, 0, 1]]),
        }
    with open(osp.join(root, "cameras.pkl"), "wb") as f:
        pickle.dump(cams, f)
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", required=True, choices=("h36m", "totalcap"))
    p.add_argument("--out", required=True)
    p.add_argument("-n", "--frames", type=int, default=4)
    p.add_argument("--seed", type=int, default=None,
                   help="default: the per-kind fixture seed (2 / 4)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.kind == "h36m":
        write_h36m(args.out, n=args.frames,
                   seed=2 if args.seed is None else args.seed)
    else:
        write_totalcap(args.out, n=args.frames,
                       seed=4 if args.seed is None else args.seed)
    print(f"wrote synthetic {args.kind} db: {args.out} "
          f"({args.frames} frames)")


if __name__ == "__main__":
    main()
