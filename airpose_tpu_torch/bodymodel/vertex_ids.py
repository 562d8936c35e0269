"""Body-only vertex mask from the reference's hand/face vertex-id assets
(copy of airpose_tpu/bodymodel/vertex_ids.py, numpy only).

The reference builds a (10475,) vertex mask that zeroes the MANO hand
vertices (``MANO_SMPLX_vertex_ids.pkl``: dict with ``left_hand`` /
``right_hand`` index arrays) and the FLAME face vertices
(``SMPL-X__FLAME_vertex_ids.npy``) and registers it as a module buffer
(ref copenet/src/copenet/copenet_twoview.py:67-72) — but never applies it
to the vertex loss. Per SURVEY §2.2 ("keep as a flag") it is an opt-in
here: ``trainer --body_only_verts DIR`` loads the mask from the
reference-layout asset directory and every supervised vertex-MSE term is
computed over body-only vertices (hands/face zeroed on both prediction
and ground truth).
"""

import os
import pickle

import numpy as np

MANO_IDS_FILE = "MANO_SMPLX_vertex_ids.pkl"
FLAME_IDS_FILE = "SMPL-X__FLAME_vertex_ids.npy"


def load_body_vertex_mask(assets_dir: str, num_verts: int = 10475) -> np.ndarray:
    """(num_verts,) float32 mask: 1 for body vertices, 0 for hands/face.

    Reads whichever of the two reference asset files are present in
    ``assets_dir``; raises if neither exists (an empty mask would silently
    turn the flag into a no-op).
    """
    mask = np.ones((num_verts,), np.float32)
    mano_path = os.path.join(assets_dir, MANO_IDS_FILE)
    flame_path = os.path.join(assets_dir, FLAME_IDS_FILE)
    found = False
    if os.path.exists(mano_path):
        with open(mano_path, "rb") as f:
            ids = pickle.load(f)
        for hand in ("left_hand", "right_hand"):
            idx = np.asarray(ids[hand], dtype=np.int64)
            _check_ids(idx, num_verts, f"{MANO_IDS_FILE}:{hand}")
            mask[idx] = 0.0
        found = True
    if os.path.exists(flame_path):
        idx = np.load(flame_path).astype(np.int64).reshape(-1)
        _check_ids(idx, num_verts, FLAME_IDS_FILE)
        mask[idx] = 0.0
        found = True
    if not found:
        raise FileNotFoundError(
            f"no {MANO_IDS_FILE} or {FLAME_IDS_FILE} in {assets_dir}"
        )
    return mask


def _check_ids(idx: np.ndarray, num_verts: int, name: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= num_verts):
        raise ValueError(
            f"{name}: vertex ids out of range [0, {num_verts}) "
            f"(min {idx.min()}, max {idx.max()}) — wrong body model?"
        )
