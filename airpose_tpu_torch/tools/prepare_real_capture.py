"""End-to-end real-capture preparation (port of
airpose_tpu/tools/prepare_real_capture.py; OpenCV, and matplotlib for
``--plot-markers`` only): videos / frame dirs → the ``machine_N`` layout
`data/real.CopenetRealDataset` consumes.

The reference's preparation is a run-cell-by-cell notebook-style script
with hardcoded cluster paths (ref copenet_real_data/scripts/
prepare_copenet_dataset.py:17-137: extract calib frames → chessboard
calibrate → save yml → extract capture frames → ArUco detection →
markerposes pkl, plus a downsample pass). Here it is one CLI per camera
machine:

    python -m airpose_tpu_torch.tools.prepare_real_capture \
        --machine_dir data/machine_1 \
        --calib calib.MP4 --capture DJI_0091.MP4 DJI_0092.MP4 \
        --square_size 0.025 --marker_length 0.555 --downsample 2

producing

    machine_1/images/%06d.jpg
    machine_1/camera_calib.yml
    machine_1/markerposes_corrected_all.pkl

``--calib``/``--capture`` accept video files OR directories of frames.
openpose_res.pkl / alphapose_res.json come from the external detectors —
the reference also runs those out of band (prepare_copenet_dataset.py's
final "run openpose and alphapose" step).
"""

import importlib.util
import os
import os.path as osp
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from .calibration import (
    calibrate_chessboard,
    detect_aruco_poses,
    save_calib_yml,
)


def _iter_source_frames(source: str, stride: int = 1, downsample: int = 1):
    """Yield RGB-agnostic BGR frames from a video file or a frame dir."""
    import cv2

    if osp.isdir(source):
        names = sorted(
            n for n in os.listdir(source)
            if n.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        for i, n in enumerate(names):
            if i % stride:
                continue
            img = cv2.imread(osp.join(source, n))
            if img is not None:
                yield img[::downsample, ::downsample]
        return
    cap = cv2.VideoCapture(source)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            yield frame[::downsample, ::downsample]
        i += 1
    cap.release()


def calibrate_machine(machine_dir: str, calib_source: str,
                      board: Tuple[int, int] = (9, 6),
                      square_size: float = 0.025,
                      calib_stride: int = 50,
                      downsample: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Chessboard-calibrate from a calib video/dir and write
    camera_calib.yml (ref prepare_copenet_dataset.py:19-54). Returns
    (K, dist).

    Calibration always runs on FULL-resolution calib frames (sub-pixel
    corner accuracy); with ``downsample`` > 1 the saved K is rescaled to
    the downsampled capture geometry (fx, fy, cx, cy ÷ N) so the yml, the
    ArUco extrinsics, and the images/ frames stay mutually consistent —
    the distortion coefficients act on normalized coordinates and are
    scale-invariant."""
    frames = list(_iter_source_frames(calib_source, stride=calib_stride))
    if not frames:
        raise ValueError(f"no calibration frames in {calib_source}")
    K, dist, rms = calibrate_chessboard(frames, board=board,
                                        square_size=square_size)
    K = np.asarray(K, np.float64).copy()
    if downsample > 1:
        K[:2] /= downsample
    os.makedirs(machine_dir, exist_ok=True)
    save_calib_yml(osp.join(machine_dir, "camera_calib.yml"), K, dist)
    print(f"calibrated: rms {rms:.3f}px over {len(frames)} frames"
          + (f" (K rescaled for downsample {downsample})"
             if downsample > 1 else ""))
    return K, np.asarray(dist)


def extract_capture(machine_dir: str, capture_sources: Sequence[str],
                    stride: int = 1, downsample: int = 1) -> int:
    """Concatenate capture videos/dirs into machine_dir/images/%06d.jpg
    with continuous numbering (ref prepare_copenet_dataset.py:57-75 per
    video; the reference keeps per-video dirs, the reader consumes one
    flat ``images/``)."""
    import cv2

    out_dir = osp.join(machine_dir, "images")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for src in capture_sources:
        for frame in _iter_source_frames(src, stride=stride,
                                         downsample=downsample):
            cv2.imwrite(osp.join(out_dir, f"{n:06d}.jpg"), frame)
            n += 1
    return n


def detect_markerposes(machine_dir: str, K: np.ndarray, dist: np.ndarray,
                       marker_length: float = 0.555) -> dict:
    """ArUco pose per frame of machine_dir/images →
    markerposes_corrected_all.pkl (ref prepare_copenet_dataset.py:96-137;
    frame key = zero-padded index string, marker id keys inside)."""
    import cv2

    images_dir = osp.join(machine_dir, "images")
    poses = {}
    for name in sorted(os.listdir(images_dir)):
        img = cv2.imread(osp.join(images_dir, name))
        if img is None:
            continue
        det = detect_aruco_poses(img, K, dist, marker_length=marker_length)
        if det:
            poses[name.split(".")[0]] = det
    out = osp.join(machine_dir, "markerposes_corrected_all.pkl")
    with open(out, "wb") as f:
        pickle.dump(poses, f)
    print(f"markerposes: {len(poses)} frames with detections → {out}")
    return poses


def prepare_machine(machine_dir: str,
                    calib_source: Optional[str] = None,
                    capture_sources: Sequence[str] = (),
                    board: Tuple[int, int] = (9, 6),
                    square_size: float = 0.025,
                    calib_stride: int = 50,
                    stride: int = 1,
                    downsample: int = 1,
                    marker_length: float = 0.555,
                    skip_aruco: bool = False) -> None:
    """The full per-machine chain. With no ``calib_source``, an existing
    camera_calib.yml in ``machine_dir`` is reused."""
    import cv2

    if calib_source:
        K, dist = calibrate_machine(machine_dir, calib_source, board,
                                    square_size, calib_stride,
                                    downsample=downsample)
    else:
        # a reused yml is trusted as-is: it must already describe the
        # geometry of the frames in images/ (incl. any prior downsample)
        yml = osp.join(machine_dir, "camera_calib.yml")
        fs = cv2.FileStorage(yml, cv2.FILE_STORAGE_READ)
        K = fs.getNode("K").mat()
        d = fs.getNode("D").mat()
        fs.release()
        if K is None:
            raise ValueError(f"no --calib given and no K in {yml}")
        dist = d if d is not None else np.zeros(5)

    if capture_sources:
        n = extract_capture(machine_dir, capture_sources, stride=stride,
                            downsample=downsample)
        print(f"extracted {n} capture frames")

    if not skip_aruco:
        detect_markerposes(machine_dir, K, dist, marker_length)


def plot_markerposes(pkl_path: str, out_path: str) -> None:
    """Diagnostic plot of each marker's rvec/tvec over frame index — the
    reference's plotly inspection cells (ref
    prepare_copenet_dataset.py:140-198) as one matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(pkl_path, "rb") as f:
        poses = pickle.load(f)
    by_marker: dict = {}
    for fkey, dets in poses.items():
        t = int(fkey)
        for mid, rt in dets.items():
            by_marker.setdefault(mid, []).append(
                (t, np.asarray(rt["rvec"]).ravel(),
                 np.asarray(rt["tvec"]).ravel()))

    fig, axes = plt.subplots(max(len(by_marker), 1), 2,
                             figsize=(10, 3 * max(len(by_marker), 1)),
                             squeeze=False)
    for row, (mid, entries) in enumerate(sorted(by_marker.items())):
        entries.sort()
        ts = [e[0] for e in entries]
        rv = np.stack([e[1] for e in entries])
        tv = np.stack([e[2] for e in entries])
        for idx, c in enumerate("rgb"):
            axes[row][0].plot(ts, np.degrees(rv[:, idx]), c, lw=0.8)
            axes[row][1].plot(ts, tv[:, idx], c, lw=0.8)
        axes[row][0].set_title(f"marker {mid} rvec (deg)")
        axes[row][1].set_title(f"marker {mid} tvec (m)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Prepare one camera machine's directory for "
        "CopenetRealDataset (calibration + frames + ArUco extrinsics).")
    p.add_argument("--machine_dir", required=True)
    p.add_argument("--calib", default=None,
                   help="calibration video or frame dir (omit to reuse an "
                        "existing camera_calib.yml)")
    p.add_argument("--capture", nargs="*", default=[],
                   help="capture videos or frame dirs, concatenated in "
                        "order into images/")
    p.add_argument("--board", type=int, nargs=2, default=(9, 6),
                   help="chessboard inner corners (ref camera_calib "
                        "defaults 9 6)")
    p.add_argument("--square_size", type=float, default=0.025)
    p.add_argument("--calib_stride", type=int, default=50,
                   help="use every Nth calib frame (ref skip_frames=50)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--downsample", type=int, default=1,
                   help="spatial downsample factor (ref's separate "
                        "downsample pass, prepare_copenet_dataset.py:200+)")
    p.add_argument("--marker_length", type=float, default=0.555,
                   help="ArUco side length in meters (ref :122)")
    p.add_argument("--skip-aruco", action="store_true")
    p.add_argument("--plot-markers", action="store_true",
                   help="write markerposes.png diagnostics (the ref's "
                        "plotly inspection cells)")
    args = p.parse_args(argv)

    prepare_machine(
        args.machine_dir, args.calib, args.capture,
        board=tuple(args.board), square_size=args.square_size,
        calib_stride=args.calib_stride, stride=args.stride,
        downsample=args.downsample, marker_length=args.marker_length,
        skip_aruco=args.skip_aruco,
    )
    if args.plot_markers:
        pkl_path = osp.join(args.machine_dir,
                            "markerposes_corrected_all.pkl")
        if importlib.util.find_spec("matplotlib") is None:
            print("--plot-markers: matplotlib is not installed here; the "
                  "markerposes.png plot is left out")
        elif osp.exists(pkl_path):  # incl. a pre-existing one under --skip-aruco
            plot_markerposes(
                pkl_path, osp.join(args.machine_dir, "markerposes.png"))
        else:
            print(f"--plot-markers: no {pkl_path} to plot "
                  "(run without --skip-aruco first)")


if __name__ == "__main__":
    main()
