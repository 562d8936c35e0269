"""Pkl dataset → HDF5 export (port of airpose_tpu/tools/to_hdf5.py; ref
copenet_real_data/scripts/copenet_data_hdf5.py). h5py is imported where a
file is written.

Two modes, mirroring the reference script's two halves:

* default: packs a per-sample-pkl AerialPeople dataset into one HDF5 file
  with a group per sample, preserving the reference key names
  (ref copenet_data_hdf5.py:1-35).
* ``--real``: packs a real DJI capture + an AirPose results pkl into the
  flat layout the reference exports "for Julia"
  (ref copenet_data_hdf5.py:38-109): per-split 2D keypoints per camera
  (``joints2d_{split}_gt{0,1}``, each (N, 2, 24, 3) stacked
  [openpose, alphapose] as the reference's ``get_j2d_only`` concat),
  SMPL-wrt-camera 4×4 poses built from the predicted root
  orientation/translation (``smpl_wrt_cam{0,1}_{split}``), and the frame
  paths (``im{0,1}_{split}``). The reference script's copy-paste slips
  (test translations taken from the train split, test rotmats for cam1
  taken from cam0's train split) are NOT replicated — each split/camera
  uses its own predictions. ``--splits`` must name the splits of the
  compile_results run that produced the pkl, in the same order (that
  CLI's default is a single ``test`` split; pass ``--splits test train``
  for a ``--split test train`` run), and ``--first_cam`` must match the
  compile run's camera pinning so predictions pair with the right
  machine's keypoints/frames.

Usage:
  python -m airpose_tpu_torch.tools.to_hdf5 --datapath DIR --split train --out f.h5
  python -m airpose_tpu_torch.tools.to_hdf5 --real --datapath CAPTURE \\
      --outputs_pkl results.pkl --out f.h5 [--splits test train] \\
      [--test_frames 8000 15000 --train_frames 0 7000] [--first_cam 0]
  (each with ``--platform cpu`` where there is no CUDA device)
"""

import argparse
import os
import pickle

import numpy as np
import torch

from .. import resolve_device


def export_split(datapath: str, split: str, out_path: str) -> int:
    import h5py

    with open(os.path.join(datapath, "dataset", f"{split}_pkls.pkl"), "rb") as f:
        files = pickle.load(f)
    with h5py.File(out_path, "w") as h5:
        for i, path in enumerate(files):
            with open(path, "rb") as f:
                sample = pickle.load(f)
            g = h5.create_group(f"{i:06d}")
            for key, val in sample.items():
                if isinstance(val, dict):
                    sub = g.create_group(key)
                    for k2, v2 in val.items():
                        sub.create_dataset(k2, data=np.asarray(v2))
                elif isinstance(val, str):
                    g.attrs[key] = val
                else:
                    g.create_dataset(key, data=np.asarray(val))
    return len(files)


def _smpl_wrt_cam(split_outputs, view: int, device=None) -> np.ndarray:
    """Outputs-pkl rows → (N, 4, 4) SMPL-root-wrt-camera transforms
    (ref copenet_data_hdf5.py:62-88: axis-angle root → rotmat on
    ``device``, plus the predicted camera-frame translation)."""
    from ..geometry.rotations import batch_rodrigues

    angles = np.concatenate(
        [o["output"][f"pred_angles{view}"] for o in split_outputs])
    trans = np.concatenate(
        [o["output"][f"pred_smpltrans{view}"] for o in split_outputs])
    n = angles.shape[0]
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = batch_rodrigues(
        torch.from_numpy(angles[:, 0]).to(resolve_device(device))).cpu().numpy()
    T[:, :3, 3] = trans
    return T


def export_real(datapath: str, outputs_pkl: str, out_path: str,
                splits, frame_ranges, first_cam: int = 0, device=None) -> int:
    """Real-capture export: keypoints + predicted SMPL poses + frame paths
    per split. ``splits`` must match the outputs pkl's split order and
    ``first_cam`` the compile run's camera pinning (with ``first_cam=1``
    prediction view 0 is machine_2, so cam keys pair machine-wise); the
    rotations are built on ``device`` (CUDA by default)."""
    import h5py

    from ..data.real import CopenetRealDataset

    with open(outputs_pkl, "rb") as f:
        per_split = pickle.load(f)
    if len(per_split) != len(splits):
        raise SystemExit(
            f"outputs pkl has {len(per_split)} splits, --splits names "
            f"{len(splits)} — they must correspond in order (name the "
            f"compile_results run's --split values)")

    # prediction-view → machine index (data/real.py host_batch view order)
    order = (1, 0) if first_cam == 1 else (0, 1)
    n_total = 0
    with h5py.File(out_path, "w") as h5:
        for split, split_outputs in zip(splits, per_split):
            ds = CopenetRealDataset(
                datapath, frame_range=range(*frame_ranges[split]))
            n_pred = sum(
                o["output"]["pred_angles0"].shape[0] for o in split_outputs)
            n = min(len(ds), n_pred)
            if n < max(len(ds), n_pred):
                print(f"WARNING {split}: {len(ds)} frames vs {n_pred} "
                      f"predictions — exporting the common first {n}")
            for m in (0, 1):  # cam key m == machine_{m+1}
                v = order.index(m)  # the prediction view that saw machine m
                # (N, 2, 24, 3) stacked [openpose, alphapose], the
                # reference get_j2d_only concat layout
                kp = np.stack(
                    [np.stack([ds.keypoints(i)["openpose"][m],
                               ds.keypoints(i)["alphapose"][m]])
                     for i in range(n)])
                h5.create_dataset(f"joints2d_{split}_gt{m}", data=kp)
                h5.create_dataset(
                    f"smpl_wrt_cam{m}_{split}",
                    data=_smpl_wrt_cam(split_outputs, v, device)[:n])
                paths = [ds.image_paths[m][i].encode("ascii", "ignore")
                         for i in range(n)]
                h5.create_dataset(f"im{m}_{split}", data=paths)
            n_total += n
    return n_total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datapath", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--real", action="store_true",
                   help="real-capture export (needs --outputs_pkl)")
    p.add_argument("--split", default="train", choices=("train", "test"),
                   help="AerialPeople mode: which split to pack")
    p.add_argument("--outputs_pkl", default=None,
                   help="real mode: AirPose results pkl from "
                        "compile_results --datapath real://")
    p.add_argument("--splits", nargs="+", default=("test",),
                   help="real mode: split names in the outputs pkl's order "
                        "(= the compile_results run's --split values; that "
                        "CLI's default is one 'test' split)")
    p.add_argument("--train_frames", type=int, nargs=2, default=(0, 7000))
    p.add_argument("--test_frames", type=int, nargs=2, default=(8000, 15000))
    p.add_argument("--first_cam", type=int, default=0, choices=(0, 1),
                   help="real mode: the compile run's --first_cam, so "
                        "predictions pair with the right machine")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device of --real's rotations (the CUDA card by "
                        "default; raises without it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)
    if args.real:
        if not args.outputs_pkl:
            p.error("--real requires --outputs_pkl")
        ranges = {"train": tuple(args.train_frames),
                  "test": tuple(args.test_frames)}
        n = export_real(args.datapath, args.outputs_pkl, args.out,
                        tuple(args.splits), ranges, first_cam=args.first_cam,
                        device=dev)
    else:
        n = export_split(args.datapath, args.split, args.out)
    print(f"exported {n} samples to {args.out}")


if __name__ == "__main__":
    main()
