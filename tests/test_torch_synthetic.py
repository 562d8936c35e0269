"""The port's synthetic two-view dataset (airpose_tpu_torch.data.synthetic):
shapes, and ground truth consistent with the conventions of
airpose_tpu/data/synthetic.py, on the CPU. Its draws come from a
torch.Generator, so they differ from the JAX package's; the conventions are
held here instead: projecting the GT reproduces ``gt_j2d``, the crop
coordinates follow ``bb``, and the GT parameters, fed to ``twoview_loss`` as
predictions, give zero for every term that compares with GT.

Tolerances: f32 arithmetic on pixel coordinates up to ~2000 (atol 1e-3 px),
on crop coordinates (atol 1e-3) and on the loss terms (atol as stated)."""

import pytest
import torch

from airpose_tpu_torch import constants as C
from airpose_tpu_torch.bodymodel import smplx_forward, synthetic_smplx_params
from airpose_tpu_torch.config import LossWeights
from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
from airpose_tpu_torch.geometry.rotations import rotmat_to_rot6d
from airpose_tpu_torch.train.losses import twoview_loss

N, V, S = 5, 222, 48


@pytest.fixture(scope="module")
def smplx_small():
    return synthetic_smplx_params(num_vertices=V, seed=3)


@pytest.fixture(scope="module")
def data(smplx_small):
    return make_synthetic_dataset(smplx_small, num_samples=N, seed=5, img_size=S,
                                  blob_sigma=3.0)


def test_shapes_and_determinism(smplx_small, data):
    want = {"images": (N, 2, S, S, 3), "bb": (N, 2, 3), "intr": (N, 2, 3, 3),
            "extr": (N, 2, 3, 4), "gt_trans": (N, 2, 3), "gt_orient": (N, 2, 3, 3),
            "gt_pose_rotmat": (N, 21, 3, 3), "gt_betas": (N, 10), "gt_vertices": (N, V, 3),
            "gt_joints": (N, 127, 3), "gt_j2d": (N, 2, 22, 2), "gt_j2d_crop": (N, 2, 22, 2)}
    assert {k: tuple(v.shape) for k, v in data.items()} == want
    assert all(v.dtype == torch.float32 for v in data.values())
    again = make_synthetic_dataset(smplx_small, num_samples=N, seed=5, img_size=S,
                                   blob_sigma=3.0)
    assert all(torch.equal(data[k], again[k]) for k in data)
    other = make_synthetic_dataset(smplx_small, num_samples=N, seed=6, img_size=S)
    assert not torch.equal(data["gt_betas"], other["gt_betas"])


def test_projecting_gt_reproduces_j2d(data):
    cam = (torch.einsum("nvij,nkj->nvki", data["gt_orient"], data["gt_joints"][:, :22])
           + data["gt_trans"][:, :, None])
    assert (cam[..., 2] > 0).all()
    uv = torch.einsum("nvij,nvkj->nvki", data["intr"], cam / cam[..., 2:])[..., :2]
    torch.testing.assert_close(uv, data["gt_j2d"], atol=1e-3, rtol=0)
    # the per-view root pose is the camera's rotation of one world pose
    R_cam = data["extr"][..., :3]
    world = torch.einsum("nvji,nvjk->nvik", R_cam, data["gt_orient"])
    torch.testing.assert_close(world[:, 0], world[:, 1], atol=1e-5, rtol=0)


def test_crop_coordinates_follow_bb(data):
    bb = data["bb"]
    center = (bb[..., :2] + 1.0) * torch.tensor([C.CX, C.CY])
    crop = bb[..., 2, None, None] * (data["gt_j2d"] - center[:, :, None])
    torch.testing.assert_close(crop, data["gt_j2d_crop"], atol=1e-3, rtol=0)
    # the joints' box ± 50 px fits the crop, whose longer side is S
    assert (data["gt_j2d_crop"].abs() <= S / 2 + 1e-3).all()
    # each joint's blob peaks near its crop position (pixel = crop + S/2)
    img = data["images"][..., 0] * C.IMG_NORM_STD[0] + C.IMG_NORM_MEAN[0]
    px = (data["gt_j2d_crop"] + S / 2).round().long().clamp(0, S - 1)
    n, v = 0, 0
    peak = img[n, v, px[n, v, 0, 1], px[n, v, 0, 0]]
    assert peak > 0.5 and img[n, v].min() >= 0.0


def test_gt_is_the_canonical_body(smplx_small, data):
    eye = torch.eye(3).expand(N, 1, 3, 3)
    out = smplx_forward(smplx_small, data["gt_betas"], body_pose=data["gt_pose_rotmat"],
                        global_orient=eye)
    assert torch.equal(out.vertices, data["gt_vertices"])
    assert torch.equal(out.joints, data["gt_joints"])


def test_gt_as_prediction_zeroes_the_gt_terms(smplx_small, data):
    """The dataset's conventions are the loss's: GT parameters in the IEF
    state layout [trans·scale | root 6D | 21×6D] score zero on every term
    that compares with GT."""
    rot = torch.cat([data["gt_orient"][:, :, None],
                     data["gt_pose_rotmat"][:, None].expand(N, 2, 21, 3, 3)], dim=2)
    pose = torch.cat([data["gt_trans"] * C.TRANS_SCALE,
                      rotmat_to_rot6d(rot).reshape(N, 2, -1)], dim=-1)
    betas = data["gt_betas"][:, None].expand(N, 2, 10)
    batch = batch_slice(data, 0, N, "cpu")
    _, m = twoview_loss(pose, betas, batch, smplx_small, LossWeights())
    for k, atol in (("loss_keypoints", 1e-4), ("loss_keypoints_3d", 1e-10),
                    ("loss_regr_shape", 1e-10), ("loss_regr_trans", 1e-10),
                    ("loss_rootrot", 1e-10), ("loss_regr_pose", 1e-10)):
        assert m[k].item() <= atol, (k, m[k].item())
