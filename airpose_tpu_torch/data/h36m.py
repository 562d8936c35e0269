"""Human3.6M two-view reader — the reference's h36m loaders, modernized
(port of airpose_tpu/data/h36m.py; numpy on the host, OpenCV imported only
when images are decoded).

The reference ships `h36m_full_train` / `h36m_full_test` (+ crop
variants) reading a prebuilt `dsets/h36m_db.pkl` (per-frame dict:
`c1..c4` image paths, `gt` (32·3,) world joints in mm, `s` subject id)
plus `dsets/h36m_cameras.h5` (`subject<S>/camera<N>/{R,T,f,c}`), frames
cropped to 1000×1000, train = cameras 1/2, test = cameras 3/4 with a
random view swap (ref copenet/src/copenet/dsets/h36m.py:24-145). That
code is legacy-broken in the reference itself (imports from pre-packaging
module paths, h36m.py:12-15) and sits outside the active training path —
this port reads the SAME on-disk layout into the canonical host-batch
contract (context windows + person boxes + per-view GT) so the modern
pipeline (data/pipeline.finish_batch) can consume it.

H36M has joint GT only (no SMPL-X parameters): batches carry cam-frame
`gt_joints` (the 17 movable-joint subset the reference keeps,
h36m.py:20) and projected `gt_j2d`; SMPL fields are absent, exactly like
the real-data reader's missing-3D-GT posture (dsets/copenet_real.py:
244-258 fills NaN).
"""

import os.path as osp
import pickle
from typing import Dict, Sequence

import numpy as np

# the 17 movable H36M joints of the 32-joint skeleton (ref h36m.py:20)
H36M_MOVABLE = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)
_CROP = 1000  # ref crops frames to [:1000, :1000] (h36m.py:51-52)


class H36MDataset:
    """``root`` holds ``dsets/h36m_db.pkl`` + ``dsets/h36m_cameras.h5``
    (the reference's prebuilt-database layout). ``split``: train → cameras
    (1, 2), test → cameras (3, 4), matching h36m_full_train/test."""

    def __init__(self, root: str, split: str = "train",
                 context_size: int = 672, shuffle_cams: bool = True,
                 validate: bool = True):
        from .validate import PathResolver, validate_h36m

        self.root = root
        self.split = split
        self.cams = (1, 2) if split == "train" else (3, 4)
        self.context_size = context_size
        self.shuffle_cams = shuffle_cams
        with open(osp.join(root, "dsets", "h36m_db.pkl"), "rb") as f:
            self.db = pickle.load(f)
        self._cam_cache: Dict = {}
        self._resolve = PathResolver(root)
        if validate:
            # loud first-contact diagnosis: key/shape/unit drift in a real
            # h36m_db.pkl fails here, not as a silent mis-scale downstream
            validate_h36m(root, self.db, H36M_MOVABLE, self._resolve)

    def __len__(self) -> int:
        return len(self.db)

    def _camera(self, subject: str, cam: int):
        key = (subject, cam)
        if key not in self._cam_cache:
            import h5py

            with h5py.File(osp.join(self.root, "dsets", "h36m_cameras.h5"),
                           "r") as h5:
                g = h5[f"subject{subject}"][f"camera{cam}"]
                R = np.asarray(g["R"][()], np.float32)
                # T in mm → m (ref h36m_crop_train divides by 1000,
                # h36m.py:200-210; the full variants keep mm — the metric
                # convention here is meters throughout)
                T = np.asarray(g["T"][()], np.float32).reshape(3) / 1000.0
                K = np.eye(3, dtype=np.float32)
                K[0, 0], K[1, 1] = np.asarray(g["f"][()]).reshape(2)
                K[:2, 2] = np.asarray(g["c"][()]).reshape(2)
            # h36m_cameras.h5 stores (R, T) with T = camera center in
            # world coords; the camera transform is x_cam = Rᵀ(x − T)
            # (ref utils/utils.py:96-107 npPerspProj: extr_rot = Rᵀ,
            # extr_trans = −Rᵀ·T, points_local = x·R + extr_trans).
            # Store the world→cam [Rᵀ | −Rᵀ·T] so `extr` means the same
            # thing as the real-data reader's per-frame extrinsics.
            extr = np.eye(4, dtype=np.float32)
            extr[:3, :3] = R.T
            extr[:3, 3] = -R.T @ T
            self._cam_cache[key] = (K, extr)
        return self._cam_cache[key]

    def host_batch(self, indices: Sequence[int], rng: np.random.Generator,
                   decode_images: bool = True, swap_cams: bool = None) -> Dict:
        from .pipeline import decode_pool

        if swap_cams is None:
            swap_cams = self.shuffle_cams
        B = len(indices)
        S = self.context_size
        J = len(H36M_MOVABLE)
        out = {
            "context": np.zeros((B, 2, S, S, 3), np.uint8),
            "context_extent": np.zeros((B, 2, 2), np.float32),
            "context_origin": np.zeros((B, 2, 2), np.float32),
            "context_scale": np.ones((B, 2), np.float32),
            "person_box": np.zeros((B, 2, 4), np.float32),
            "intr": np.zeros((B, 2, 3, 3), np.float32),
            "extr": np.zeros((B, 2, 4, 4), np.float32),
            "gt_joints": np.zeros((B, 2, J, 3), np.float32),
            "gt_j2d": np.zeros((B, 2, J, 2), np.float32),
        }
        orders = [
            (1, 0) if swap_cams and rng.integers(2) == 1 else (0, 1)
            for _ in indices
        ]  # random camera interchange (ref h36m.py:73-75)

        jobs, paths = [], {}
        for b, idx in enumerate(indices):
            rec = self.db[idx]
            for v, ci in enumerate(orders[b]):
                cam = self.cams[ci]
                paths[(b, v)] = self._resolve(rec[f"c{cam}"])
                jobs.append((b, v))

        decoded = {}
        if decode_images:
            import cv2

            def _read(job):
                return job, cv2.imread(paths[job])

            decoded = dict(decode_pool(8).map(_read, jobs))

        for b, idx in enumerate(indices):
            rec = self.db[idx]
            gt_world = np.asarray(rec["gt"], np.float32).reshape(-1, 3)
            gt_world = gt_world[list(H36M_MOVABLE)] / 1000.0  # mm → m
            for v, ci in enumerate(orders[b]):
                cam = self.cams[ci]
                K, extr = self._camera(rec["s"], cam)
                out["intr"][b, v] = K
                out["extr"][b, v] = extr
                jc = gt_world @ extr[:3, :3].T + extr[:3, 3]
                out["gt_joints"][b, v] = jc
                uv = (jc / np.maximum(jc[:, 2:], 1e-6)) @ K.T
                out["gt_j2d"][b, v] = uv[:, :2]

                img = decoded.get((b, v))
                if img is not None:
                    img = img[:_CROP, :_CROP]
                # clamp the box to the ACTUAL frame geometry (≤ the
                # reference's 1000×1000 pre-crop): claiming a box larger
                # than the decoded content would skew the bb conditioning
                # and 2D supervision finish_batch derives from it (same
                # frame-size-aware clamp as data/real.py person_crop_box)
                fh, fw = (img.shape[:2] if img is not None
                          else (_CROP, _CROP))
                xs, ys = uv[:, 0], uv[:, 1]
                xmin = max(int(xs.min()) - 50, 0)
                ymin = max(int(ys.min()) - 50, 0)
                xmax = min(int(xs.max()) + 50, fw)
                ymax = min(int(ys.max()) + 50, fh)
                if xmax <= xmin or ymax <= ymin:  # subject off-frame
                    xmin, ymin, xmax, ymax = 0, 0, fw, fh
                out["context_origin"][b, v] = (xmin, ymin)
                out["person_box"][b, v] = (0.0, 0.0, xmax - xmin, ymax - ymin)
                out["context_extent"][b, v] = (xmax - xmin, ymax - ymin)
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
