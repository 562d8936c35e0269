"""A synthetic two-drone DJI capture in the layout data/real.py reads, for
smoke runs of the real:// fine-tune without a real capture:

  python -m airpose_tpu_torch.data.fake_real DIR [--frames N]

writes DIR/machine_{1,2}/ with N frames of 1920×1080 JPEGs (noise
upsampled from a quarter-size draw), ``openpose_res.pkl`` (25 joints at
confidence 0.9 inside a person-sized window), ``alphapose_res.json`` (the
first 18 of them moved by a few pixels, confidence 0.8),
``markerposes_corrected_all.pkl`` and ``camera_calib.yml``. The draws
follow tests/test_data.py's fixture writer from its seed, so the two write
the same capture.
"""

import argparse
import json
import os
import pickle

import numpy as np

SEED = 1  # the fixture writer's


def write_fake_real_capture(root: str, n: int = 4, scale: float = 1.0) -> None:
    """Write an ``n``-frame capture under ``root``; ``scale`` < 1 writes a
    downsampled one (frames, keypoints and K shrunk together)."""
    import cv2

    rng = np.random.default_rng(SEED)
    W, H = int(1920 * scale), int(1080 * scale)
    for m in (1, 2):
        mdir = os.path.join(root, f"machine_{m}")
        os.makedirs(os.path.join(mdir, "images"), exist_ok=True)
        op, ap, marker = {}, {}, {}
        for i in range(n):
            key = f"{i:06d}"
            kp25 = np.zeros((1, 25, 3), np.float32)
            kp25[0, :, 0] = rng.uniform(800, 1100, 25) * scale
            kp25[0, :, 1] = rng.uniform(400, 700, 25) * scale
            kp25[0, :, 2] = 0.9
            op[key] = {"pose": kp25}
            kp18 = np.zeros((18, 3), np.float32)
            kp18[:, 0] = kp25[0, :18, 0] + rng.normal(0, 3, 18) * scale
            kp18[:, 1] = kp25[0, :18, 1] + rng.normal(0, 3, 18) * scale
            kp18[:, 2] = 0.8
            ap[key] = {"people": [{"pose_keypoints_2d": kp18.reshape(-1).tolist()}]}
            marker[key] = {"0": {"rvec": rng.normal(0, 0.1, 3).astype(np.float64),
                                 "tvec": np.asarray([0.1 * m, 0.0, 2.0])}}
            img = (rng.random((1080 // 4, 1920 // 4, 3)) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(mdir, "images", f"{key}.jpg"), cv2.resize(img, (W, H)))
        with open(os.path.join(mdir, "openpose_res.pkl"), "wb") as f:
            pickle.dump(op, f)
        with open(os.path.join(mdir, "alphapose_res.json"), "w") as f:
            json.dump(ap, f)
        with open(os.path.join(mdir, "markerposes_corrected_all.pkl"), "wb") as f:
            pickle.dump(marker, f)
        K = np.asarray([[1537.0 * scale, 0, 960 * scale],
                        [0, 1517.0 * scale, 540 * scale], [0, 0, 1]])
        fs = cv2.FileStorage(os.path.join(mdir, "camera_calib.yml"), cv2.FILE_STORAGE_WRITE)
        fs.write("K", K)
        fs.release()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    write_fake_real_capture(args.root, args.frames)
    print(f"wrote a {args.frames}-frame capture under {args.root}")


if __name__ == "__main__":
    main()
