"""Port parity: rotations, skinning, synthetic SMPL-X and its forward
(airpose_tpu_torch vs airpose_tpu on the same numpy inputs, on the CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.bodymodel import smplx as jsmplx
from airpose_tpu.bodymodel.pallas_lbs import skinning_pallas
from airpose_tpu.geometry import rotations as jrot
from airpose_tpu_torch.bodymodel import cuda_lbs
from airpose_tpu_torch.bodymodel import smplx as tsmplx
from airpose_tpu_torch.geometry import rotations as trot


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,shape", [
    ("rot6d_to_rotmat", (4, 22, 6)),
    ("batch_rodrigues", (4, 21, 3)),
    ("quat_to_rotmat", (7, 4)),
])
def test_rotations_match_jax(rng, name, shape):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    got = getattr(trot, name)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rotmat_to_rot6d_inverts(rng):
    R = trot.rot6d_to_rotmat(_t(rng.normal(size=(5, 6)).astype(np.float32)))
    np.testing.assert_allclose(trot.rot6d_to_rotmat(trot.rotmat_to_rot6d(R)).numpy(),
                               R.numpy(), atol=1e-6)


@pytest.mark.parametrize("V,B,J", [
    pytest.param(333, 2, 55, id="333-2"),
    pytest.param(1024, 3, 55, id="1024-3"),
    pytest.param(300, 2, 24, id="J24"),
    pytest.param(256, 2, 128, id="J128"),      # the TPU kernel's joint padding
    pytest.param(1023, 2, 55, id="V1023"),     # V not a multiple of 4
])
def test_skinning_reference_matches_pallas(rng, V, B, J):
    w = rng.random((V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    p = rng.normal(size=(B, V, 3)).astype(np.float32)

    want = np.asarray(skinning_pallas(jnp.asarray(w), jnp.asarray(rel),
                                      jnp.asarray(p), interpret=True))
    got = cuda_lbs.skinning(_t(w), _t(rel), _t(p))  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("V,B,J", [
    pytest.param(333, 2, 55, id="333-2"),
    pytest.param(1023, 5, 24, id="J24"),
    pytest.param(10475, 4, 55, id="smplx"),
])
def test_skinning_backward_matches_autograd(rng, V, B, J):
    """The skinning Function's backward (torch ops, run here on the CPU)
    against autograd through the plain einsum pair: f32 sums in other
    orders, within 1e-5 of each gradient's largest entry."""
    w = rng.random((V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    rel = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    a, p = _t(rel).requires_grad_(True), _t(rng.normal(size=(B, V, 3)).astype(np.float32))
    p.requires_grad_(True)
    g = _t(rng.normal(size=(B, V, 3)).astype(np.float32))
    want = torch.autograd.grad(cuda_lbs.skinning_reference(_t(w), a, p), (a, p), g)
    got = cuda_lbs.skinning_backward(_t(w), a.detach(), p.detach(), g)
    assert got[0].shape == (B, J, 4, 4) and got[1].shape == (B, V, 3)
    assert torch.equal(got[0][:, :, 3], torch.zeros(B, J, 4))
    for x, y in zip(got, want):
        assert ((x - y).abs().max() / y.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("V", [512, 10475])
def test_synthetic_smplx_params_equal_jax(V):
    jp = jsmplx.synthetic_smplx_params(num_vertices=V)
    tp = tsmplx.synthetic_smplx_params(num_vertices=V)
    assert tp.parents == tuple(jp.parents)
    np.testing.assert_array_equal(tp.faces, jp.faces)
    # the expression directions are the port's own (the JAX model has none),
    # drawn after every array the two share
    assert tp.expr_dirs.shape == (V, 3, tsmplx.NUM_EXPRESSION)
    for f in dataclasses.fields(tp):
        if f.name in ("parents", "faces", "expr_dirs"):
            continue
        got, want = getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name))
        if f.name == "hand_pose":  # batch_rodrigues in each framework
            np.testing.assert_allclose(got, want, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_smplx_params_from_numpy_roundtrip():
    jp = jsmplx.synthetic_smplx_params(num_vertices=64, seed=3)
    tp = tsmplx.smplx_params_from_numpy(**{
        f.name: getattr(jp, f.name) for f in dataclasses.fields(tsmplx.SMPLXParams)
        if f.name != "expr_dirs"})
    assert tp.expr_dirs is None
    np.testing.assert_array_equal(tp.lbs_weights.numpy(), np.asarray(jp.lbs_weights))
    assert tp.extra_joint_ids.dtype == torch.int64


@pytest.mark.parametrize("pose2rot", [False, True])
def test_smplx_forward_matches_jax(rng, pose2rot):
    V, B = 512, 3
    jp = jsmplx.synthetic_smplx_params(num_vertices=V)
    tp = tsmplx.synthetic_smplx_params(num_vertices=V)
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    aa = (rng.normal(size=(B, 22, 3)) * 0.3).astype(np.float32)
    transl = rng.normal(size=(B, 3)).astype(np.float32)
    if pose2rot:
        body, orient = aa[:, 1:].reshape(B, 63), aa[:, 0]
    else:
        R = np.asarray(jrot.batch_rodrigues(jnp.asarray(aa)))
        body, orient = R[:, 1:], R[:, :1]

    want = jsmplx.smplx_forward(jp, jnp.asarray(betas), jnp.asarray(body),
                                jnp.asarray(orient), transl=jnp.asarray(transl),
                                pose2rot=pose2rot)
    got = tsmplx.smplx_forward(tp, _t(betas), _t(body), _t(orient),
                               transl=_t(transl), pose2rot=pose2rot)
    assert got.vertices.shape == (B, V, 3) and got.joints.shape == (B, 127, 3)
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(want.vertices), atol=2e-5)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(want.joints), atol=2e-5)


def test_load_smplx_npz_matches_jax(tmp_path, rng):
    V, J = 300, 55
    f = np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], 1)
    path = tmp_path / "SMPLX_NEUTRAL.npz"
    np.savez(
        path,
        v_template=rng.normal(size=(V, 3)), shapedirs=rng.normal(size=(V, 3, 20)),
        posedirs=rng.normal(size=(V, 3, (J - 1) * 9)) * 1e-3,
        J_regressor=rng.random((J, V)) / V, weights=rng.random((V, J)),
        kintree_table=np.stack([np.asarray(jsmplx.SMPLX_PARENTS), np.arange(J)]),
        f=f, hands_meanl=rng.normal(size=45) * 0.1,
        hands_meanr=rng.normal(size=45) * 0.1,
        lmk_faces_idx=rng.integers(0, V - 2, 51),
        lmk_bary_coords=rng.random((51, 3)),
    )
    jp = jsmplx.load_smplx_npz(str(tmp_path))
    tp = tsmplx.load_smplx_npz(str(tmp_path))
    assert tp.parents == tuple(jp.parents)
    for name in ("v_template", "shape_dirs", "pose_dirs", "lmk_vert_ids", "lmk_bary"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_allclose(tp.hand_pose.numpy(), np.asarray(jp.hand_pose), atol=1e-6)
