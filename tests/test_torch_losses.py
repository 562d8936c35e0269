"""Port parity: the supervised losses and the folded two-view SMPL-X forward
(airpose_tpu_torch.train.losses vs airpose_tpu.train.losses on identical
predictions and one JAX-made synthetic batch, on the CPU, f32).

Tolerance: every loss term within rtol 1e-5 of JAX's. Both sides run the
same f32 arithmetic through SMPL-X (whose vertices agree to ~1e-6,
tests/test_torch_lbs.py); the terms are means of squares of those."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.bodymodel import synthetic_smplx_params as j_synthetic
from airpose_tpu.config import LossWeights as JLossWeights
from airpose_tpu.data import make_synthetic_dataset
from airpose_tpu.data.joints import SMPLX_TO_H36M17 as J_H36M
from airpose_tpu.train import losses as JL
from airpose_tpu_torch.bodymodel import synthetic_smplx_params
from airpose_tpu_torch.config import LossWeights
from airpose_tpu_torch.data.joints import SMPLX_TO_H36M17
from airpose_tpu_torch.train import losses as TL

B, V, RTOL = 3, 333, 1e-5


@pytest.fixture(scope="module")
def models():
    return j_synthetic(num_vertices=V, seed=3), synthetic_smplx_params(num_vertices=V, seed=3)


@pytest.fixture(scope="module")
def batch(models):
    return make_synthetic_dataset(models[0], num_samples=B, seed=5, img_size=32,
                                  blob_sigma=2.0)


def _preds(seed=0, views=2):
    rng = np.random.default_rng(seed)
    lead = (B, views) if views else (B,)
    pose = rng.normal(size=lead + (135,)).astype(np.float32) * 0.3
    pose[..., :3] = rng.normal(size=lead + (3,)) * 0.02 + np.asarray([0.0, 0.0, 0.45])
    betas = rng.normal(size=lead + (10,)).astype(np.float32) * 0.5
    cam = np.abs(rng.normal(size=lead + (3,))).astype(np.float32) * 0.3 + 0.5
    return pose, betas, cam


def _check(got, want):
    tot_g, met_g = got
    tot_w, met_w = want
    assert set(met_g) == set(met_w)
    for k in met_w:
        np.testing.assert_allclose(met_g[k].detach().numpy(), np.asarray(met_w[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tot_g.detach().numpy(), np.asarray(tot_w), rtol=RTOL)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_config_matches_jax():
    assert dataclasses.asdict(LossWeights()) == dataclasses.asdict(JLossWeights())
    from airpose_tpu.config import TrainConfig as JTrainConfig
    from airpose_tpu_torch.config import TrainConfig
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    assert SMPLX_TO_H36M17 == J_H36M


def test_canonical_smplx_two_view_matches_jax(models):
    pose, betas, _ = _preds(1)
    from airpose_tpu.geometry.rotations import rot6d_to_rotmat
    rotmat = np.array(rot6d_to_rotmat(jnp.asarray(pose[..., 3:].reshape(B, 2, 22, 6))))
    jv, jj = JL.canonical_smplx_two_view(models[0], jnp.asarray(betas), jnp.asarray(rotmat))
    tv, tj = TL.canonical_smplx_two_view(models[1], torch.from_numpy(betas),
                                         torch.from_numpy(rotmat))
    assert tv.shape == (B, 2, V, 3) and tj.shape == (B, 2, 127, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=2e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["all-vertices", "vertex-mask"])
def test_twoview_loss_matches_jax(models, batch, masked):
    pose, betas, _ = _preds(2)
    mask = (np.arange(V) % 3 != 0).astype(np.float32) if masked else None
    want = JL.twoview_loss(jnp.asarray(pose), jnp.asarray(betas), _j(batch), models[0],
                           JLossWeights(), vertex_mask=None if mask is None else jnp.asarray(mask))
    got = TL.twoview_loss(torch.from_numpy(pose), torch.from_numpy(betas), _t(batch), models[1],
                          LossWeights(),
                          vertex_mask=None if mask is None else torch.from_numpy(mask))
    _check(got, want)
    if masked:  # the mask changes the shape term and only it
        full = TL.twoview_loss(torch.from_numpy(pose), torch.from_numpy(betas), _t(batch),
                               models[1], LossWeights())[1]
        changed = {k for k in full if not torch.equal(full[k], got[1][k])}
        assert changed == {"loss", "loss_regr_shape"}


def test_joints_loss_matches_jax(models, batch):
    """H36M-style GT: cam-frame 3D joints and their projections, built from
    the synthetic GT as tests/test_train.py builds them."""
    sel = list(J_H36M)
    canon = batch["gt_joints"][:, sel]
    cam_j = (np.einsum("bvij,bkj->bvki", batch["gt_orient"], canon)
             + batch["gt_trans"][:, :, None])
    j2d = np.einsum("bvij,bvkj->bvki", batch["intr"], cam_j / cam_j[..., 2:])[..., :2]
    jb = {"images": batch["images"], "bb": batch["bb"], "intr": batch["intr"],
          "gt_joints": cam_j.astype(np.float32), "gt_j2d": j2d.astype(np.float32)}
    pose, betas, _ = _preds(3)
    want = JL.joints_loss(jnp.asarray(pose), jnp.asarray(betas), _j(jb), models[0],
                          JLossWeights())
    got = TL.joints_loss(torch.from_numpy(pose), torch.from_numpy(betas), _t(jb), models[1],
                         LossWeights())
    _check(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["all-vertices", "vertex-mask"])
def test_singleview_loss_matches_jax(models, batch, masked):
    pose, betas, _ = _preds(4, views=0)
    mask = (np.arange(V) % 2 == 0).astype(np.float32) if masked else None
    want = JL.singleview_loss(jnp.asarray(pose), jnp.asarray(betas), _j(batch), models[0],
                              JLossWeights(),
                              vertex_mask=None if mask is None else jnp.asarray(mask))
    got = TL.singleview_loss(torch.from_numpy(pose), torch.from_numpy(betas), _t(batch),
                             models[1], LossWeights(),
                             vertex_mask=None if mask is None else torch.from_numpy(mask))
    _check(got, want)


def test_weak_cam_project_matches_jax(rng):
    R = rng.normal(size=(B, 3, 3)).astype(np.float32)
    cam = (np.abs(rng.normal(size=(B, 3))) + 0.5).astype(np.float32)
    joints = rng.normal(size=(B, 7, 3)).astype(np.float32)
    want = JL._weak_cam_project(jnp.asarray(R), jnp.asarray(cam), jnp.asarray(joints),
                                (1475.0, 1475.0), 224)
    got = TL._weak_cam_project(torch.from_numpy(R), torch.from_numpy(cam),
                               torch.from_numpy(joints), (1475.0, 1475.0), 224)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all-vertices", "vertex-mask"])
def test_hmr_loss_matches_jax(models, batch, masked):
    pose, betas, cam = _preds(5, views=0)
    mask = (np.arange(V) % 4 != 1).astype(np.float32) if masked else None
    want = JL.hmr_loss(jnp.asarray(pose[:, 3:]), jnp.asarray(betas), jnp.asarray(cam),
                       _j(batch), models[0], JLossWeights(),
                       vertex_mask=None if mask is None else jnp.asarray(mask))
    got = TL.hmr_loss(torch.from_numpy(pose[:, 3:]), torch.from_numpy(betas),
                      torch.from_numpy(cam), _t(batch), models[1], LossWeights(),
                      vertex_mask=None if mask is None else torch.from_numpy(mask))
    _check(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["all-vertices", "vertex-mask"])
def test_muhmr_loss_matches_jax(models, batch, masked):
    pose, betas, cam = _preds(6)
    mask = (np.arange(V) % 5 != 2).astype(np.float32) if masked else None
    want = JL.muhmr_loss(jnp.asarray(pose[..., 3:]), jnp.asarray(betas), jnp.asarray(cam),
                         _j(batch), models[0], JLossWeights(),
                         vertex_mask=None if mask is None else jnp.asarray(mask))
    got = TL.muhmr_loss(torch.from_numpy(pose[..., 3:]), torch.from_numpy(betas),
                        torch.from_numpy(cam), _t(batch), models[1], LossWeights(),
                        vertex_mask=None if mask is None else torch.from_numpy(mask))
    _check(got, want)
