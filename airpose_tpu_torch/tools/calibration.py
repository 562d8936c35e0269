"""Camera calibration + ArUco extrinsics tooling (port of
airpose_tpu/tools/calibration.py; OpenCV only, imported where it is used).

Covers the reference's real-data preparation pipeline (ref
copenet_real_data/scripts/camera_calib.py:12-85,
prepare_copenet_dataset.py:96-137, aruco_gen.py): chessboard intrinsic
calibration with cv2 yml save/load, 4x4_50 ArUco marker generation, and
per-frame marker-pose extrinsics extraction into the
markerposes_corrected_all.pkl format the real dataset reader consumes.
"""

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def calibrate_from_points(
    object_points: Sequence[np.ndarray],
    image_points: Sequence[np.ndarray],
    image_size: Tuple[int, int],
):
    """cv2.calibrateCamera over correspondences → (K, dist, rms)."""
    import cv2

    rms, K, dist, _, _ = cv2.calibrateCamera(
        [np.asarray(o, np.float32) for o in object_points],
        [np.asarray(i, np.float32) for i in image_points],
        image_size, None, None,
    )
    return K, dist, rms


def calibrate_chessboard(
    images: Sequence[np.ndarray], board: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
):
    """Find chessboard corners in calibration frames and calibrate
    (ref camera_calib.py:12-60)."""
    import cv2

    objp = np.zeros((board[0] * board[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0 : board[0], 0 : board[1]].T.reshape(-1, 2)
    objp *= square_size
    obj_pts, img_pts = [], []
    size = None
    for img in images:
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
        size = gray.shape[::-1]
        found, corners = cv2.findChessboardCorners(gray, board)
        if found:
            corners = cv2.cornerSubPix(
                gray, corners, (11, 11), (-1, -1),
                (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
            )
            obj_pts.append(objp)
            img_pts.append(corners.reshape(-1, 2))
    if not obj_pts:
        raise ValueError("no chessboards found")
    return calibrate_from_points(obj_pts, img_pts, size)


def save_calib_yml(path: str, K: np.ndarray, dist: Optional[np.ndarray] = None):
    """cv2 FileStorage yml — the format camera_calib.yml readers expect."""
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("K", np.asarray(K, np.float64))
    if dist is not None:
        fs.write("D", np.asarray(dist, np.float64))
    fs.release()


def generate_aruco_marker(marker_id: int = 0, size_px: int = 400) -> np.ndarray:
    """4x4_50 dictionary marker image (ref aruco_gen.py)."""
    import cv2

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    return cv2.aruco.generateImageMarker(d, marker_id, size_px)


def detect_aruco_poses(
    image: np.ndarray, K: np.ndarray, dist: np.ndarray,
    marker_length: float = 1.0,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Detect 4x4_50 markers and solve each pose → {marker_id: {rvec, tvec}}
    (the per-frame entry of markerposes_corrected_all.pkl, ref
    prepare_copenet_dataset.py:96-137)."""
    import cv2

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    detector = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY) if image.ndim == 3 else image
    corners, ids, _ = detector.detectMarkers(gray)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    if ids is None:
        return out
    half = marker_length / 2.0
    obj = np.asarray(
        [[-half, half, 0], [half, half, 0], [half, -half, 0], [-half, -half, 0]],
        np.float32,
    )
    for c, mid in zip(corners, ids.ravel()):
        ok, rvec, tvec = cv2.solvePnP(
            obj, c.reshape(-1, 2).astype(np.float32),
            np.asarray(K, np.float64), np.asarray(dist, np.float64),
        )
        if ok:
            out[str(int(mid))] = {
                "rvec": rvec.reshape(3), "tvec": tvec.reshape(3)
            }
    return out


def build_markerposes_pkl(
    frames: Dict[str, np.ndarray], K: np.ndarray, dist: np.ndarray,
    out_path: str, marker_length: float = 1.0,
):
    """{frame_key: image} → markerposes_corrected_all.pkl."""
    poses = {
        key: detect_aruco_poses(img, K, dist, marker_length)
        for key, img in frames.items()
    }
    with open(out_path, "wb") as f:
        pickle.dump(poses, f)
    return poses


def extract_frames(video_path: str, out_dir: str, stride: int = 1,
                   downsample: int = 1) -> int:
    """Video → %06d.jpg frames (ref prepare_copenet_dataset.py video step)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    n = 0
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            if downsample > 1:
                frame = frame[::downsample, ::downsample]
            cv2.imwrite(os.path.join(out_dir, f"{n:06d}.jpg"), frame)
            n += 1
        i += 1
    cap.release()
    return n
