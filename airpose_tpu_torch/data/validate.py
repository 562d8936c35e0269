"""Loud schema validation + path relocation for prebuilt mocap databases
(copy of airpose_tpu/data/validate.py, numpy only; h5py imported lazily).

The reference acknowledges on-disk drift by rewriting the absolute paths
stored inside its pickles when a dataset is unpacked on a new machine
(ref copenet/src/copenet/scripts/prepare_aerialpeople_dataset.py:1-16).
`h36m_db.pkl` / `totalcap_db.pkl` come from machines nobody here controls, so
key variants, mm-vs-m conventions and stale absolute frame paths are all
expected drift. These validators make the FIRST contact with a real db
fail with a diagnosis — which key is missing, which field has the wrong
shape, which unit looks wrong and what was expected — instead of a silent
mis-scale; `PathResolver` relocates stale absolute frame paths under the
local root the way the reference's prepare script rewrites them.

Validation reads record 0 only (plus the camera files), so it is O(1) in
dataset size and runs unconditionally at loader construction.
"""

import os.path as osp
from typing import Dict, Sequence

import numpy as np


class DbSchemaError(ValueError):
    """A prebuilt database does not match the expected on-disk schema."""


def require_keys(rec: Dict, keys: Sequence[str], what: str) -> None:
    if not isinstance(rec, dict):
        raise DbSchemaError(
            f"{what}: expected a dict record, got {type(rec).__name__}")
    missing = [k for k in keys if k not in rec]
    if missing:
        present = sorted(str(k) for k in rec)[:24]
        raise DbSchemaError(
            f"{what}: missing required key(s) {missing}; "
            f"keys present: {present}")


def float_field(rec: Dict, key: str, what: str, min_size: int = 1,
                divisible: int = 1) -> np.ndarray:
    """Coerce rec[key] to float64 and check its element count."""
    try:
        arr = np.asarray(rec[key], np.float64)
    except (TypeError, ValueError) as e:
        raise DbSchemaError(
            f"{what}: field '{key}' is not numeric "
            f"({type(rec[key]).__name__}): {e}") from None
    if arr.size < min_size or arr.size % divisible != 0:
        raise DbSchemaError(
            f"{what}: field '{key}' has {arr.size} elements "
            f"(shape {arr.shape}); expected >= {min_size}"
            + (f" and divisible by {divisible}" if divisible > 1 else ""))
    if not np.all(np.isfinite(arr)):
        raise DbSchemaError(f"{what}: field '{key}' contains non-finite "
                            f"values")
    return arr


def check_rotation(R: np.ndarray, what: str, tol: float = 1e-2) -> None:
    R = np.asarray(R, np.float64)
    if R.shape != (3, 3):
        raise DbSchemaError(f"{what}: expected a (3, 3) rotation, got shape "
                            f"{R.shape}")
    err = float(np.abs(R @ R.T - np.eye(3)).max())
    if err > tol:
        raise DbSchemaError(
            f"{what}: not orthonormal (|R·Rᵀ − I|∞ = {err:.3g}); the stored "
            f"matrix is not a rotation — wrong field or corrupted db")


class PathResolver:
    """Resolve db-stored frame paths against the local root.

    Relative paths join the root. Stale absolute paths (recorded on the
    machine that wrote the db) are relocated by progressively stripping leading
    components until the file exists under the root — the same move the
    reference's prepare_aerialpeople_dataset.py path-rewrite performs.
    The successful strip depth is cached, so after the first frame the
    resolution is a single join.
    """

    def __init__(self, root: str):
        self.root = root
        self._strip = None  # components stripped off absolute paths

    def __call__(self, p: str) -> str:
        if not osp.isabs(p):
            return osp.join(self.root, p)
        if self._strip is not None:
            tail = p.lstrip("/").split("/")[self._strip:]
            # guard: a cached depth >= this path's component count would
            # collapse the candidate to the root itself (which exists)
            if tail:
                cand = osp.join(self.root, *tail)
                if osp.exists(cand):
                    return cand
        if osp.exists(p):
            return p
        parts = p.lstrip("/").split("/")
        for i in range(len(parts)):
            cand = osp.join(self.root, *parts[i:])
            if osp.exists(cand):
                self._strip = i
                return cand
        return p  # unresolved; probe() turns this into a diagnosis

    def probe(self, p: str, what: str) -> str:
        """Resolve and REQUIRE existence, listing every candidate tried."""
        res = self(p)
        if osp.exists(res):
            return res
        tried = [p if osp.isabs(p) else osp.join(self.root, p)]
        if osp.isabs(p):
            parts = p.lstrip("/").split("/")
            tried += [osp.join(self.root, *parts[i:])
                      for i in range(len(parts))]
        raise DbSchemaError(
            f"{what}: frame path '{p}' not found; tried "
            f"{tried[:8]}{' …' if len(tried) > 8 else ''}. If the db stores "
            f"absolute paths from another machine, place the frames under "
            f"'{self.root}' preserving their trailing components (the "
            f"reference's prepare_*_dataset.py path rewrite)")


def _extent(points: np.ndarray) -> float:
    """Bounding-box diagonal of an (N, 3) point cloud."""
    return float(np.linalg.norm(points.max(0) - points.min(0)))


def validate_h36m(root: str, db, movable: Sequence[int],
                  resolver: PathResolver) -> None:
    """Schema + unit sanity for dsets/h36m_db.pkl + dsets/h36m_cameras.h5
    (layout of ref copenet/src/copenet/dsets/h36m.py:24-60; world joints
    in MILLIMETRES, camera centres in mm)."""
    what = "h36m_db.pkl"
    if not isinstance(db, (list, tuple)) or len(db) == 0:
        raise DbSchemaError(
            f"{what}: expected a non-empty list of per-frame dicts, got "
            f"{type(db).__name__} of length "
            f"{len(db) if hasattr(db, '__len__') else '?'}")
    rec = db[0]
    require_keys(rec, ["s", "gt", "c1", "c2", "c3", "c4"],
                 f"{what} record 0")
    gt = float_field(rec, "gt", f"{what} record 0", min_size=3, divisible=3)
    joints = gt.reshape(-1, 3)
    if joints.shape[0] <= max(movable):
        raise DbSchemaError(
            f"{what} record 0: 'gt' has {joints.shape[0]} joints; the "
            f"movable-joint subset needs index {max(movable)} "
            f"(expected the 32-joint H36M skeleton, 96 floats)")
    diag = _extent(joints[list(movable)])
    if diag < 25.0:
        raise DbSchemaError(
            f"{what} record 0: human extent {diag:.3g} looks like METRES; "
            f"this layout stores world joints in MILLIMETRES "
            f"(ref dsets/h36m.py GT convention) — multiply by 1000 when "
            f"building the db, do not pre-convert")
    if not (250.0 <= diag <= 6000.0):
        raise DbSchemaError(
            f"{what} record 0: implausible human extent {diag:.3g} mm "
            f"(expected 250–6000 mm for a person)")

    h5_path = osp.join(root, "dsets", "h36m_cameras.h5")
    if not osp.exists(h5_path):
        raise DbSchemaError(f"h36m_cameras.h5 not found at {h5_path}")
    import h5py

    with h5py.File(h5_path, "r") as h5:
        sgrp = f"subject{rec['s']}"
        if sgrp not in h5:
            raise DbSchemaError(
                f"h36m_cameras.h5: no group '{sgrp}' for record-0 subject "
                f"'{rec['s']}'; groups present: {sorted(h5.keys())[:10]}")
        for cam in (1, 2, 3, 4):
            cgrp = f"{sgrp}/camera{cam}"
            if cgrp not in h5:
                raise DbSchemaError(
                    f"h36m_cameras.h5: missing '{cgrp}'; cameras present "
                    f"under {sgrp}: {sorted(h5[sgrp].keys())}")
            g = h5[cgrp]
            require_keys({k: None for k in g.keys()}, ["R", "T", "f", "c"],
                         f"h36m_cameras.h5 {cgrp}")
            check_rotation(g["R"][()], f"h36m_cameras.h5 {cgrp}/R")
            T = np.asarray(g["T"][()], np.float64).ravel()
            if T.size != 3:
                raise DbSchemaError(f"h36m_cameras.h5 {cgrp}/T: expected 3 "
                                    f"values, got shape {T.shape}")
            if np.linalg.norm(T) < 50.0:
                raise DbSchemaError(
                    f"h36m_cameras.h5 {cgrp}/T: camera centre norm "
                    f"{np.linalg.norm(T):.3g} looks like METRES; this "
                    f"layout stores centres in MILLIMETRES")
            for k, n in (("f", 2), ("c", 2)):
                v = np.asarray(g[k][()], np.float64).ravel()
                if v.size != n:
                    raise DbSchemaError(f"h36m_cameras.h5 {cgrp}/{k}: "
                                        f"expected {n} values, got shape "
                                        f"{v.shape}")

    for cam in (1, 2, 3, 4):
        resolver.probe(rec[f"c{cam}"], f"{what} record 0 'c{cam}'")


def validate_totalcap(root: str, db, cams: Dict, view_pair,
                      resolver: PathResolver) -> None:
    """Schema + unit sanity for dsets/totalcap_db.pkl + cameras.pkl
    (layout of ref copenet/src/copenet/dsets/totalcap.py:43-80; SMPL GT
    in world METRES, axis-angle poses in radians; cameras.pkl stores the
    camera POSE, which the reader inverts)."""
    what = "totalcap_db.pkl"
    if not isinstance(db, (list, tuple)) or len(db) == 0:
        raise DbSchemaError(
            f"{what}: expected {{'db': non-empty list of per-frame "
            f"dicts}}, got db of type {type(db).__name__}, length "
            f"{len(db) if hasattr(db, '__len__') else '?'}")
    rec = db[0]
    need = ["poses", "betas", "trans"] + [f"im{c}" for c in view_pair]
    require_keys(rec, need, f"{what} record 0")
    poses = float_field(rec, "poses", f"{what} record 0", min_size=66,
                        divisible=3)
    if float(np.abs(poses).max()) > 10.0:
        raise DbSchemaError(
            f"{what} record 0: 'poses' max |value| = "
            f"{np.abs(poses).max():.3g}; axis-angle poses are RADIANS "
            f"(|aa| ≤ π per joint) — this looks like degrees or a wrong "
            f"field")
    float_field(rec, "betas", f"{what} record 0", min_size=10)
    trans = float_field(rec, "trans", f"{what} record 0", min_size=3)
    tnorm = float(np.linalg.norm(trans.ravel()[:3]))
    if tnorm > 100.0:
        raise DbSchemaError(
            f"{what} record 0: 'trans' norm {tnorm:.3g} looks like "
            f"MILLIMETRES; this layout stores SMPL translation in METRES")

    if not isinstance(cams, dict):
        raise DbSchemaError(f"cameras.pkl: expected a dict of cam<N> "
                            f"entries, got {type(cams).__name__}")
    for c in view_pair:
        key = f"cam{c}"
        if key not in cams:
            raise DbSchemaError(
                f"cameras.pkl: missing '{key}' for view_pair {view_pair}; "
                f"cameras present: {sorted(cams.keys())[:12]}")
        cam = cams[key]
        require_keys(cam, ["extr", "trans", "intr"], f"cameras.pkl {key}")
        check_rotation(cam["extr"], f"cameras.pkl {key}/extr")
        ct = np.asarray(cam["trans"], np.float64).ravel()
        if ct.size != 3:
            raise DbSchemaError(f"cameras.pkl {key}/trans: expected 3 "
                                f"values, got shape {ct.shape}")
        if np.linalg.norm(ct) > 100.0:
            raise DbSchemaError(
                f"cameras.pkl {key}/trans: camera centre norm "
                f"{np.linalg.norm(ct):.3g} looks like MILLIMETRES; this "
                f"layout stores centres in METRES")
        K = np.asarray(cam["intr"], np.float64)
        if K.shape != (3, 3) or K[0, 0] <= 0 or K[1, 1] <= 0:
            raise DbSchemaError(
                f"cameras.pkl {key}/intr: expected a (3, 3) K with "
                f"positive focals, got shape {K.shape}, "
                f"f = ({K.ravel()[0]:.3g}, …)")

    for c in view_pair:
        resolver.probe(rec[f"im{c}"], f"{what} record 0 'im{c}'")
