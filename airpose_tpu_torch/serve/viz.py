"""Result visualization — the copenet_rosViz equivalent (port of
airpose_tpu/serve/viz.py).

The reference subscribes to the step3 ROS topic, decodes the 145-float
message, runs SMPL-X, and shows the mesh in meshcat (ref
copenet_real/scripts/copenet_rosViz.py:82-104). Here: decode recorded
145-float results, run SMPL-X on the device (skinning through the CUDA
kernel on the card), then render mesh overlays to PNGs with the software
rasterizer. The PNGs are written with OpenCV, not matplotlib (which the
JAX package uses), since the card's machine has no matplotlib; the image
content is the same.

Usage:
  python -m airpose_tpu_torch.serve.viz --wire results.npy --out viz/ \
      [--smplx_model_dir DIR] [--focal 1475 1475] [--platform cpu]
  (results.npy: (N, 145) float32 wire messages)
"""

import argparse
import os

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device


def render_wire_messages(
    wire: np.ndarray, smplx_params, out_dir: str,
    focal=(1475.0, 1475.0), image_size=(960, 540), max_frames: int = 16,
    device=None,
):
    """(N, 145) wire floats → overlay PNGs. Returns written paths. The
    SMPL-X forward runs on ``device`` (CUDA by default; raises without it).

    ``focal`` is expressed at the capture's FULL resolution
    (constants.IMG_SIZE, 1920×1080 — the convention every focal constant
    in this codebase uses); it is rescaled per-axis to whatever
    ``image_size`` canvas is rendered, so a full-res canvas projects
    correctly too (not just the half-res default)."""
    import cv2

    from ..bodymodel.smplx import smplx_forward
    from ..geometry.rotations import rot6d_to_rotmat
    from ..utils.render import overlay_mesh
    from .protocol import unpack_params

    dev = resolve_device(device)
    smplx_params = smplx_params.to(dev)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(min(len(wire), max_frames)):
        betas, trans, pose6d = unpack_params(wire[i])
        with torch.inference_mode():
            rotmat = rot6d_to_rotmat(
                torch.from_numpy(pose6d.reshape(22, 6)).to(dev)).cpu().numpy()
            # identity-root forward, then root rotation composed ABOUT THE
            # ORIGIN — the reference rosViz's transform_smpl composition
            # (ref copenet_rosViz.py:87-96) and this framework's
            # loss/eval/BA convention. Passing rotmat[0] as global_orient
            # instead would pivot at the root JOINT (standard LBS semantics)
            # and shift the mesh by j0 − R·j0. (The reference rosViz also
            # forgets to unscale the wire's ×0.05 translation —
            # res_compile.py:221 multiplies by 20 to recover metres;
            # unpack_params unscales, deliberately.)
            out = smplx_forward(
                smplx_params,
                torch.from_numpy(np.array(betas))[None].to(dev),
                body_pose=torch.from_numpy(rotmat[1:])[None].to(dev),
                global_orient=torch.eye(3, device=dev).expand(1, 1, 3, 3),
            )
            verts = out.vertices[0].cpu().numpy() @ rotmat[0].T + trans

        canvas = np.full(image_size[::-1] + (3,), 0.15)
        img = overlay_mesh(
            canvas, verts, smplx_params.faces,
            (focal[0] * image_size[0] / C.IMG_SIZE[0],
             focal[1] * image_size[1] / C.IMG_SIZE[1]),
            center=(image_size[0] / 2, image_size[1] / 2),
        )
        path = os.path.join(out_dir, f"frame_{i:06d}.png")
        # uint8 as matplotlib's imsave converts a float image (truncation)
        rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
            raise OSError(f"could not write {path}")
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wire", required=True, help="(N,145) .npy of wire messages")
    p.add_argument("--out", required=True)
    p.add_argument("--smplx_model_dir", default=None)
    p.add_argument("--focal", type=float, nargs=2, default=(1475.0, 1475.0))
    p.add_argument("--max-frames", type=int, default=16)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device of the SMPL-X forward (default: the CUDA "
                        "device; raises without one)")
    p.add_argument("--synthetic_verts", type=int, default=10475,
                   help="mesh size of the synthetic fallback body model")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    from ..bodymodel import load_smplx_npz, synthetic_smplx_params

    params = (
        load_smplx_npz(args.smplx_model_dir)
        if args.smplx_model_dir
        else synthetic_smplx_params(num_vertices=args.synthetic_verts)
    )
    wire = np.load(args.wire)
    paths = render_wire_messages(
        wire, params, args.out, tuple(args.focal), max_frames=args.max_frames, device=dev
    )
    print(f"wrote {len(paths)} overlays to {args.out}")


if __name__ == "__main__":
    main()
