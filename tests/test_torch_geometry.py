"""Port parity of the leaf geometry (airpose_tpu_torch.geometry vs
airpose_tpu.geometry on the same numpy inputs, on the CPU, f32), over the
cases of tests/test_geometry.py and at its tolerances: rotations 1e-5
(rotmat_to_aa 1e-4, near π 1e-3 in rotation space), projection rtol 1e-5,
rigid transforms 1e-4, triangulation 1e-3, estimate_translation 1e-2 (its
least-squares solves in f32), weak_cam_crop_to_full_trans rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from airpose_tpu.geometry import projection as jp
from airpose_tpu.geometry import robust as jr
from airpose_tpu.geometry import rotations as jrot
from airpose_tpu_torch import geometry as tg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def random_rotmats(rng, n):
    """Random rotations via QR of gaussian matrices (tests/test_geometry.py)."""
    Q, R = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    Q = Q * np.sign(np.diagonal(R, axis1=1, axis2=2))[:, None, :]
    Q[:, :, 0] *= np.linalg.det(Q)[:, None]
    return Q.astype(np.float32)


def _near_pi(rng, n=8):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return Rotation.from_rotvec(axes * (np.pi - 1e-4)).as_matrix().astype(np.float32)


@pytest.mark.parametrize("case", ["random", "identity", "near_pi", "half_turns"])
def test_rotmat_to_quat_and_aa_match_jax(rng, case):
    """Every branch of the quaternion extraction: random rotations, the
    identity, rotations within 1e-4 of π, and exact half turns about each
    axis (where the w candidate is empty and x, y or z is picked)."""
    R = {"random": lambda: random_rotmats(rng, 128),
         "identity": lambda: np.eye(3, dtype=np.float32)[None].repeat(3, 0),
         "near_pi": lambda: _near_pi(rng),
         "half_turns": lambda: np.stack([np.diag(d) for d in
                                         ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
                                        ).astype(np.float32)}[case]()
    q = tg.rotmat_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(q, np.asarray(jrot.rotmat_to_quat(_j(R))), atol=1e-5)
    assert (q[:, 0] >= 0).all()
    aa = tg.rotmat_to_aa(_t(R)).numpy()
    want = np.asarray(jrot.rotmat_to_aa(_j(R)))
    np.testing.assert_allclose(aa, want, atol=1e-3 if case in ("near_pi", "half_turns") else 1e-4)
    back = Rotation.from_rotvec(aa.astype(np.float64)).as_matrix()
    np.testing.assert_allclose(back, R, atol=1e-3 if case == "near_pi" else 1e-4)
    if case == "identity":
        np.testing.assert_allclose(aa, 0.0, atol=1e-5)


def test_rotmat_to_aa_roundtrip_through_batch_rodrigues(rng):
    R = random_rotmats(rng, 128)
    np.testing.assert_allclose(tg.batch_rodrigues(tg.rotmat_to_aa(_t(R))).numpy(), R, atol=1e-4)


def test_geman_mcclure_matches_jax():
    r = np.asarray([0.0, 1e6, 30.0, -12.5, 3e-3], np.float32)
    got = tg.geman_mcclure(_t(r), 30.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jr.geman_mcclure(_j(r), 30.0)), rtol=1e-6)
    assert got[0] == 0.0 and abs(got[2] - 0.5) < 1e-6


@pytest.mark.parametrize("center_shape", ["batch", "leading_singleton", "single"])
def test_perspective_projection_matches_jax(rng, center_shape):
    B, N = 4, 7
    pts = rng.normal(size=(B, N, 3)).astype(np.float32) + np.asarray([0, 0, 6.0], np.float32)
    rot = Rotation.from_rotvec(rng.normal(size=(B, 3)) * 0.2).as_matrix().astype(np.float32)
    trans = rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    c = np.broadcast_to(np.asarray([960.0, 540.0], np.float32), (B, 2)).copy()
    center = {"batch": c, "leading_singleton": c[None], "single": c[0]}[center_shape]
    want = np.asarray(jp.perspective_projection(_j(pts), _j(rot), _j(trans), (1475.0, 1475.0),
                                                _j(center)))
    got = tg.perspective_projection(_t(pts), _t(rot), _t(trans), (1475.0, 1475.0), _t(center))
    assert got.shape == (B, N, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    base = tg.perspective_projection(_t(pts), _t(rot), _t(trans), (1475.0, 1475.0), _t(c))
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_perspective_projection_pinhole():
    out = tg.perspective_projection(torch.tensor([[[0.0, 0.0, 5.0], [1.0, 2.0, 10.0]]]),
                                    torch.eye(3)[None], torch.zeros(1, 3), (1475.0, 1475.0),
                                    torch.tensor([[960.0, 540.0]]))
    np.testing.assert_allclose(out.numpy(), [[[960.0, 540.0], [1475 * 0.1 + 960,
                                                               1475 * 0.2 + 540]]], rtol=1e-5)


@pytest.mark.parametrize("orient_ndim", [3, 4])
def test_transform_smpl_matches_jax_and_inverts(rng, orient_ndim):
    R = random_rotmats(rng, 5)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    T = np.concatenate([R, t[:, :, None]], axis=2)
    verts = rng.normal(size=(5, 11, 3)).astype(np.float32)
    joints = rng.normal(size=(5, 4, 3)).astype(np.float32)
    orient = random_rotmats(rng, 5 * (2 if orient_ndim == 4 else 1))
    if orient_ndim == 4:
        orient = orient.reshape(5, 2, 3, 3)
    trans = rng.normal(size=(5, 3)).astype(np.float32)
    args = (T, verts, joints, orient, trans)
    got = tg.transform_smpl(*map(_t, args))
    want = jp.transform_smpl(*map(_j, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    Rinv = R.transpose(0, 2, 1)
    Tinv = np.concatenate([Rinv, -np.einsum("bij,bj->bi", Rinv, t)[:, :, None]], axis=2)
    back = tg.transform_smpl(_t(Tinv), *got)
    for b, a in zip(back, args[1:]):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4)
    assert tg.transform_smpl(_t(T)) == (None, None, None, None)
    np.testing.assert_allclose(tg.transform_points(_t(T), _t(verts)).numpy(),
                               np.asarray(jp.transform_points(_j(T), _j(verts))), atol=1e-4)


def test_weak_cam_matches_jax_and_roundtrips():
    intr = np.tile(np.asarray([[1475.0, 0, 960.0], [0, 1475.0, 540.0], [0, 0, 1.0]],
                              np.float32), (3, 1, 1))
    pos = np.asarray([[0.5, -0.2, 8.0], [1.0, 1.0, 12.0], [0.0, 0.0, -5.0]], np.float32)
    wc = tg.weak_cam_from_position(_t(intr), _t(pos))
    np.testing.assert_allclose(wc.numpy(), np.asarray(jp.weak_cam_from_position(_j(intr),
                                                                                _j(pos))),
                               rtol=1e-5)
    back = tg.weak_cam_to_trans(_t(intr), wc)
    np.testing.assert_allclose(back.numpy(), np.asarray(jp.weak_cam_to_trans(_j(intr),
                                                                             _j(wc.numpy()))),
                               rtol=1e-5)
    np.testing.assert_allclose(back.numpy()[:2], pos[:2], rtol=1e-5)


def test_triangulation_matches_jax_and_recovers_point():
    p_world = np.asarray([0.3, -0.5, 2.0])
    K = np.asarray([[[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]]] * 3)
    extr, pts2d = [], []
    for ang in (0.3, -0.4, 0.1):
        R = Rotation.from_euler("y", ang).as_matrix()
        t = np.asarray([0.1 * ang, 0.0, 4.0])
        cam_pt = R @ p_world + t
        pts2d.append((K[0] @ (cam_pt / cam_pt[2]))[:2])
        extr.append(np.concatenate([R, t[:, None]], axis=1))
    args = (K, np.stack(extr), np.stack(pts2d))
    got = tg.lstsq_triangulation(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, p_world, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jp.lstsq_triangulation(*map(_j, args))),
                               atol=1e-3)
    # 4×4 extrinsics take the same path
    e4 = np.concatenate([args[1], np.tile([[[0, 0, 0, 1.0]]], (3, 1, 1))], axis=1)
    np.testing.assert_allclose(tg.lstsq_triangulation(_t(K), _t(e4), _t(args[2])).numpy(),
                               got, atol=1e-6)


@pytest.mark.parametrize("zero_conf", [False, True])
def test_estimate_translation_matches_jax(rng, zero_conf):
    """The closed-form batched solve; with half the joints corrupted and
    their confidence zeroed, the zero-weight rows drop out."""
    B, N = 3, 24
    t_true = np.asarray([[0.2, -0.1, 7.0], [0.0, 0.3, 9.0], [-0.4, 0.1, 5.0]], np.float32)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32) * 0.4
    cam = pts + t_true[:, None]
    uv = cam[..., :2] / cam[..., 2:] * 5000.0 + 112.0
    j2d = np.concatenate([uv, np.ones((B, N, 1), np.float32)], -1)
    if zero_conf:
        j2d[:, ::2, :2] += 500.0
        j2d[:, ::2, 2] = 0.0
    got = tg.estimate_translation(_t(pts), _t(j2d)).numpy()
    np.testing.assert_allclose(got, t_true, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(jp.estimate_translation(_j(pts), _j(j2d))),
                               atol=1e-2)


def test_weak_cam_crop_to_full_trans_matches_jax(rng):
    B = 5
    cam = np.abs(rng.normal(size=(B, 3)).astype(np.float32)) + 0.3
    bb = rng.normal(size=(B, 3)).astype(np.float32) * 0.2
    bb[:, 2] = np.abs(bb[:, 2]) + 0.5
    intr = np.tile(np.asarray([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]], np.float32),
                   (B, 1, 1))
    want = np.asarray(jp.weak_cam_crop_to_full_trans(_j(cam), _j(bb), _j(intr),
                                                     (1475.0, 1475.0), 224))
    got = tg.weak_cam_crop_to_full_trans(_t(cam), _t(bb), _t(intr), (1475.0, 1475.0), 224)
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
