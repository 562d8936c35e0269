"""Synthetic AerialPeople-format dataset generator (port of
airpose_tpu/tools/create_aerialpeople.py: one SMPL-X forward a pose on the
device, so the skinning kernel on the card, at B = 1).

The reference builds its training pkls from Unreal/AirSim renders + SMPL-X
fittings (ref copenet_real_data/scripts/create_aerial_people_new.py:1-372,
prepare_aerialpeople.py). This tool writes the same per-sample pkl schema
from any SMPL-X model and camera rig — used both to regenerate
fixture/benchmark datasets and as the template for converting external
fittings into this framework's input layout:

  sample pkl keys: cam{0,1}{intr,extr}, im{0,1}, bb{0,1}, smplpose (63),
  smplshape (10), smplgender, smplorient_rotmat_wrt_origin, smpltrans,
  smpl_vertices_wrt_origin, smpl_joints_wrt_origin
  index pkls: dataset/{train,test}_pkls.pkl  (subject-level split — the
  reference holds out the last subjects, prepare_aerialpeople.py:63-79)

Usage:
  python -m airpose_tpu_torch.tools.create_aerialpeople --out DIR --subjects 4 \
      --poses-per-subject 5 [--smplx_model_dir DIR] [--render-blobs] \
      [--platform cpu]

The bounding boxes are floors of projected f32 joints, and the crop window
and the JPEG follow from them, so a joint one ulp away from the JAX tool's
can move a box by a pixel where a projection lies that close to an integer.
"""

import argparse
import os
import pickle

import numpy as np
import torch

from .. import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--subjects", type=int, default=4)
    p.add_argument("--poses-per-subject", type=int, default=5)
    p.add_argument("--test-subjects", type=int, default=1)
    p.add_argument("--smplx_model_dir", default=None)
    p.add_argument("--num-vertices", type=int, default=300,
                   help="synthetic body size when no SMPL-X assets given")
    p.add_argument("--render-blobs", action="store_true",
                   help="write joint-blob jpgs (else flat gray crops)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device of the SMPL-X forwards (the CUDA card by "
                        "default; raises without it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    import cv2

    from .. import constants as C
    from ..bodymodel import load_smplx_npz, smplx_forward, synthetic_smplx_params
    from ..geometry.rotations import batch_rodrigues

    if args.smplx_model_dir:
        params = load_smplx_npz(args.smplx_model_dir)
    else:
        params = synthetic_smplx_params(num_vertices=args.num_vertices,
                                        seed=args.seed)
    params = params.to(dev)

    def rodrigues(aa: np.ndarray) -> np.ndarray:
        return batch_rodrigues(torch.from_numpy(np.asarray(aa, np.float32))
                               .to(dev)).cpu().numpy()

    rng = np.random.default_rng(args.seed)
    os.makedirs(os.path.join(args.out, "dataset"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "pkls"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "imgs"), exist_ok=True)

    K = np.asarray(
        [[C.FOCAL_LENGTH[0], 0, C.CX], [0, C.FOCAL_LENGTH[1], C.CY], [0, 0, 1]],
        np.float32,
    )
    files_by_subject = []
    for s in range(args.subjects):
        shape = (rng.normal(size=10) * 0.5).astype(np.float32)
        gender = ["male", "female", "neutral"][s % 3]
        subject_files = []
        for k in range(args.poses_per_subject):
            pose = (rng.normal(size=63) * 0.25).astype(np.float32)
            orient_aa = (rng.normal(size=3) * 0.4).astype(np.float32)
            orient = rodrigues(orient_aa[None])[0]
            trans = rng.normal(size=3).astype(np.float32) * [1.0, 0.4, 1.0]

            canon = smplx_forward(
                params,
                torch.from_numpy(shape)[None].to(dev),
                body_pose=batch_rodrigues(
                    torch.from_numpy(pose).reshape(1, 21, 3).to(dev)),
                global_orient=torch.eye(3, device=dev).expand(1, 1, 3, 3),
            )
            verts_w = canon.vertices[0].cpu().numpy() @ orient.T + trans
            joints_w = canon.joints[0].cpu().numpy() @ orient.T + trans

            # Batched (1, ...) GT arrays: the reference's own reader feeds
            # these straight into batch-wise torch.bmm (transform_smpl,
            # ref dsets/aerialpeople.py:160-167), so an unbatched layout
            # would not be consumable by the reference — proven by
            # tests/test_reference_oracle_dataset.py, which runs the
            # reference's aerialpeople_crop on this tool's output.
            sample = {
                "smplpose": pose.reshape(63),
                "smplshape": shape,
                "smplgender": gender,
                "smplorient_rotmat_wrt_origin": orient[None],
                "smpltrans": trans[None],
                "smpl_vertices_wrt_origin": verts_w[None].astype(np.float32),
                "smpl_joints_wrt_origin": joints_w[None].astype(np.float32),
            }
            for cam in (0, 1):
                ang = rng.uniform(-0.5, 0.5)
                R = rodrigues([[0.0, ang, 0.0]])[0]
                t = np.asarray([0, 0, rng.uniform(6.0, 10.0)], np.float32)
                sample[f"cam{cam}"] = {
                    "intr": K, "extr": np.concatenate([R, t[:, None]], 1).astype(np.float32)
                }
                j = joints_w[:24] @ R.T + t
                uv = j[:, :2] / j[:, 2:] * np.asarray(C.FOCAL_LENGTH) + K[:2, 2]
                # integral bb corners: the ±200 crop window derived from the
                # bb then lands exactly on the pixel grid, so the stored
                # image extent equals the float window extent (keeps the
                # reference reader and ours bit-consistent on crop scale)
                bbmin = np.floor(
                    np.clip(uv.min(0) - 20, 0, [C.IMG_SIZE[0], C.IMG_SIZE[1]]))
                bbmax = np.floor(
                    np.clip(uv.max(0) + 20, 0, [C.IMG_SIZE[0], C.IMG_SIZE[1]]))
                sample[f"bb{cam}"] = np.stack([bbmin, bbmax]).astype(np.float32)

                x0 = int(max(bbmin[0] - 200, 0))
                y0 = int(max(bbmin[1] - 200, 0))
                x1 = int(min(bbmax[0] + 200, C.IMG_SIZE[0]))
                y1 = int(min(bbmax[1] + 200, C.IMG_SIZE[1]))
                h, w = max(y1 - y0, 8), max(x1 - x0, 8)
                if args.render_blobs:
                    img = np.zeros((h, w), np.float32)
                    for x, y in uv:
                        xi, yi = int(x - x0), int(y - y0)
                        if 0 <= xi < w and 0 <= yi < h:
                            cv2.circle(img, (xi, yi), 6, 1.0, -1)
                    img = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
                else:
                    img = np.full((h, w, 3), 128, np.uint8)
                name = f"imgs/s{s}_p{k}_c{cam}.jpg"
                cv2.imwrite(os.path.join(args.out, name), img)
                sample[f"im{cam}"] = name

            path = os.path.join(args.out, "pkls", f"s{s}_p{k}.pkl")
            with open(path, "wb") as f:
                pickle.dump(sample, f)
            subject_files.append(path)
        files_by_subject.append(subject_files)

    n_test = max(args.test_subjects, 1)
    train = [f for subj in files_by_subject[:-n_test] for f in subj]
    test = [f for subj in files_by_subject[-n_test:] for f in subj]
    for split, files in (("train", train), ("test", test)):
        with open(os.path.join(args.out, "dataset", f"{split}_pkls.pkl"), "wb") as f:
            pickle.dump(files, f)
    print(f"wrote {len(train)} train / {len(test)} test samples to {args.out}")


if __name__ == "__main__":
    main()
