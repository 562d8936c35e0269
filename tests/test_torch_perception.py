"""Port parity of the whole slice: perceive (fused-layer1 bf16 trunk → IEF →
6D → SMPL-X → projection) vs the same composition of JAX functions, with
the JAX Pallas kernels in interpret mode, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu import constants as JC
from airpose_tpu.bodymodel import smplx_forward as jsmplx_forward
from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic
from airpose_tpu.geometry.rotations import rot6d_to_rotmat as jrot6d
from airpose_tpu.models import AirPoseTwoView as JAirPoseTwoView
from airpose_tpu.models.resnet import ResNet50 as JResNet50
from airpose_tpu.ops import fused_bottleneck as jfb
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu.train.losses import cam_frame_and_project as jproject
from airpose_tpu_torch.bodymodel import synthetic_smplx_params
from airpose_tpu_torch.models import AirPoseTwoView
from airpose_tpu_torch.perception import bench_inputs, perceive
from airpose_tpu_torch.train.checkpoint import (load_reference_state_dict,
                                                state_dict_from_flax)
from airpose_tpu_torch.train.losses import cam_frame_and_project

B, IMG, V = 2, 64, 512


def _jax_perceive(variables, smplx_params, images, bb, pos, intr):
    """The root bench.py chain (bench.py:109-125) with the fused-layer1
    trunk of ops/fused_bottleneck.py::resnet50_fused_infer in place of
    model.apply's trunk (its three steps written out so that the flax parts
    run jitted)."""
    model = JAirPoseTwoView(dtype=jnp.bfloat16)
    trunk = jax.jit(JResNet50(dtype=jnp.bfloat16).apply, static_argnames="part")
    tv = {"params": variables["params"]["trunk"],
          "batch_stats": variables["batch_stats"]["trunk"]}
    stem = trunk(tv, images.reshape((B * 2,) + images.shape[2:]), part="stem")
    h = jfb.fused_stage1(stem.astype(jnp.bfloat16),
                         jfb.stage1_params_from_variables(tv), interpret=True)
    xf = trunk(tv, h, part="tail").reshape(B, 2, -1)
    out = model.apply(variables, xf, bb, pos,
                      method=lambda m, *a: m.from_features(*a))
    trans = out.pose[..., :3] / JC.TRANS_SCALE
    rotmat = jrot6d(out.pose[..., 3:].reshape(B, 2, 22, 6))
    body = jsmplx_forward(
        smplx_params, out.betas.reshape(B * 2, 10),
        body_pose=rotmat[:, :, 1:].reshape(B * 2, 21, 3, 3),
        global_orient=jnp.broadcast_to(jnp.eye(3), (B * 2, 1, 3, 3)))
    _, j2d = jproject(rotmat[:, :, 0], trans, body.joints.reshape(B, 2, -1, 3),
                      intr, JC.FOCAL_LENGTH)
    return xf, body.vertices.reshape(B, 2, -1, 3), j2d


def test_perceive_matches_jax_chain():
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in AirPoseTwoView(seed=0).state_dict().items():
        if k.endswith("running_mean"):
            v = v + torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = v * torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
        sd["model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k)] = v
    variables = convert_reference_checkpoint(sd)
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=1)
    load_reference_state_dict(model, state_dict_from_flax(variables))

    images, bb, pos, intr = bench_inputs(B, "cpu", seed=3, crop=IMG)
    bb = bb + torch.from_numpy(rng.normal(size=(B, 2, 3)).astype(np.float32) * 0.1)
    verts, j2d = perceive(model, synthetic_smplx_params(num_vertices=V),
                          images, bb, pos, intr)
    assert verts.shape == (B, 2, V, 3) and j2d.shape == (B, 2, 127, 2)

    xf_j, verts_j, j2d_j = _jax_perceive(
        variables, jsynthetic(num_vertices=V),
        *(jnp.asarray(t.numpy()) for t in (images, bb, pos, intr)))
    with torch.no_grad():
        xf = model.trunk(images.reshape(B * 2, IMG, IMG, 3))

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))

    # The trunks agree to the JAX package's own bound for its fused trunk;
    # verts and j2d inherit that bf16 rounding-point difference through the
    # IEF (measured here: xf rel-L2 8e-3, verts 2.7e-2, j2d 3e-3).
    assert rel(xf.reshape(B, 2, -1).numpy(), xf_j) < 0.1
    assert rel(verts.numpy(), verts_j) < 0.1
    assert rel(j2d.numpy(), j2d_j) < 0.02


@pytest.mark.parametrize("focal", [
    JC.FOCAL_LENGTH,                                   # one (fx, fy) pair
    ((1537.0, 1517.0), (1361.0, 1378.0)),              # per view (V, 2)
    "per_sample",                                      # per sample (B, V, 2)
])
def test_cam_frame_and_project_matches_jax(rng, focal):
    Bs, N = 3, 7
    R = np.array(jrot6d(jnp.asarray(rng.normal(size=(Bs, 2, 6)).astype(np.float32))))
    trans = (rng.normal(size=(Bs, 2, 3)) + [0, 0, 8]).astype(np.float32)
    joints = rng.normal(size=(Bs, 2, N, 3)).astype(np.float32) * 0.5
    intr = np.tile(np.eye(3, dtype=np.float32), (Bs, 2, 1, 1))
    intr[..., :2, 2] = rng.uniform(400, 900, size=(Bs, 2, 2))
    if focal == "per_sample":
        focal = rng.uniform(1000, 1600, size=(Bs, 2, 2)).astype(np.float32)
    want = jproject(*map(jnp.asarray, (R, trans, joints, intr)), focal)
    got = cam_frame_and_project(*map(torch.from_numpy, (R, trans, joints, intr)),
                                torch.as_tensor(np.asarray(focal, np.float32)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
