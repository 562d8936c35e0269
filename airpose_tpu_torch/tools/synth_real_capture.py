"""Synthetic real-layout capture generator (port of
airpose_tpu/tools/synth_real_capture.py; numpy and OpenCV only, the same
files from the same seed) — a self-contained stand-in for
a DJI two-machine capture in the exact on-disk layout
`data/real.CopenetRealDataset` consumes (ref copenet_real/dsets/
copenet_real.py:27-142: images/%06d.jpg, openpose_res.pkl,
alphapose_res.json, camera_calib.yml, markerposes_corrected_all.pkl).

Used by the dress rehearsal (tools/dress_rehearsal.py) and available as a
CLI for smoke-testing the real:// fine-tune/eval/serve/AirPose+ chain
without the (externally hosted) released capture:

    python -m airpose_tpu_torch.tools.synth_real_capture --out dir --frames 16

The "person" is a smoothly moving keypoint cluster rendered as a bright
figure on a dark background, so crops contain signal, the two detectors
agree within the gating threshold, and the temporal smoothness term of
AirPose+ has actual structure to exploit. It is not the capture
``data/fake_real.py`` writes (noise frames after tests/test_data.py's
fixture writer); the dress rehearsal uses this one.
"""

import json
import os
import os.path as osp
import pickle

import numpy as np

IMG_W, IMG_H = 1920, 1080


def _person_keypoints(rng, t, n_frames, n_joints=25):
    """25-joint OpenPose-order cluster following a smooth path."""
    cx = 960 + 350 * np.sin(2 * np.pi * t / max(n_frames, 2))
    cy = 540 + 120 * np.cos(2 * np.pi * t / max(n_frames, 2))
    # a rough standing-figure template (head up, feet down), ~300px tall
    template = np.stack([
        np.concatenate([np.linspace(-20, 20, 13), np.linspace(-60, 60, 12)]),
        np.concatenate([np.linspace(-150, 90, 13), np.linspace(-40, 150, 12)]),
    ], axis=1)[:n_joints]
    kp = template + np.asarray([cx, cy]) + rng.normal(0, 2.0, (n_joints, 2))
    return kp.astype(np.float32)


def write_machine(root: str, machine: int, n_frames: int, seed: int = 1,
                  write_images: bool = True) -> None:
    import cv2

    rng = np.random.default_rng(seed + machine)
    mdir = osp.join(root, f"machine_{machine}")
    os.makedirs(osp.join(mdir, "images"), exist_ok=True)

    op, ap, marker = {}, {}, {}
    for i in range(n_frames):
        key = f"{i:06d}"
        kp25 = _person_keypoints(rng, i + 3 * machine, n_frames)
        conf = np.full((25, 1), 0.9, np.float32)
        op[key] = {"pose": np.concatenate([kp25, conf], 1)[None]}
        kp18 = kp25[:18] + rng.normal(0, 2.0, (18, 2)).astype(np.float32)
        ap[key] = {"people": [{"pose_keypoints_2d": np.concatenate(
            [kp18, np.full((18, 1), 0.8, np.float32)], 1
        ).reshape(-1).tolist()}]}
        marker[key] = {"0": {
            "rvec": (0.05 * machine
                     + 0.02 * np.sin(i / 10.0) * np.ones(3)).astype(np.float64),
            "tvec": np.asarray([0.2 * machine, 0.0, 2.0 + 0.01 * i]),
        }}
        if write_images:
            img = np.full((IMG_H, IMG_W, 3), 30, np.uint8)
            x0, y0 = kp25.min(0).astype(int)
            x1, y1 = kp25.max(0).astype(int)
            cv2.rectangle(img, (x0, y0), (x1, y1), (90, 140, 200), -1)
            cv2.circle(img, tuple(kp25[0].astype(int)), 25, (200, 180, 160), -1)
            cv2.imwrite(osp.join(mdir, "images", f"{key}.jpg"), img)

    with open(osp.join(mdir, "openpose_res.pkl"), "wb") as f:
        pickle.dump(op, f)
    with open(osp.join(mdir, "alphapose_res.json"), "w") as f:
        json.dump(ap, f)
    with open(osp.join(mdir, "markerposes_corrected_all.pkl"), "wb") as f:
        pickle.dump(marker, f)
    K = np.asarray([[1537.0, 0, 960], [0, 1517.0, 540], [0, 0, 1]])
    fs = cv2.FileStorage(osp.join(mdir, "camera_calib.yml"),
                         cv2.FILE_STORAGE_WRITE)
    fs.write("K", K)
    fs.write("D", np.zeros((1, 5)))
    fs.release()


def write_capture(root: str, n_frames: int = 16, seed: int = 1) -> str:
    for m in (1, 2):
        write_machine(root, m, n_frames, seed=seed)
    return root


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    write_capture(args.out, args.frames, args.seed)
    print(f"wrote synthetic capture ({args.frames} frames x 2 machines) "
          f"to {args.out}")


if __name__ == "__main__":
    main()
