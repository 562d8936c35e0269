"""Port parity of the eval metrics (airpose_tpu_torch.eval vs airpose_tpu.eval
on the same numpy inputs, on the CPU, f32) at synthetic_smplx_params(222).

Tolerances: the closed-form metrics rtol 1e-6 (a few f32 roundings); the
Procrustes alignment atol 1e-5 (an f32 SVD through torch and through XLA:
the singular vectors may differ in sign, R = U·D·Vᵀ and the aligned points
may not; measured 1.1e-6); metrics through the SMPL-X forward rtol 1e-5
(f32 sums in other orders; measured 2.5e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic
from airpose_tpu.eval import metrics as jm
from airpose_tpu_torch import eval as tm
from airpose_tpu_torch.bodymodel import synthetic_smplx_params

V = 222


@pytest.fixture(scope="module")
def smplx_pair():
    return jsynthetic(num_vertices=V, seed=4), synthetic_smplx_params(num_vertices=V, seed=4)


def _rotmats(rng, shape, scale=0.3):
    aa = rng.normal(size=shape + (3,)) * scale
    return Rotation.from_rotvec(aa.reshape(-1, 3)).as_matrix().reshape(shape + (3, 3)
                                                                       ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _check(got, want, rtol):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=rtol, err_msg=k)


def test_mpjpe_and_mpe_match_jax(rng):
    a, b = (rng.normal(size=(4, 30, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tm.mpjpe(_t(a), _t(b)).item(), float(jm.mpjpe(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tm.mpe(_t(a[:, 0]), _t(b[:, 0])).item(),
                               float(jm.mpe(a[:, 0], b[:, 0])), rtol=1e-6)
    assert tm.mpjpe(torch.zeros(2, 22, 3), torch.ones(2, 22, 3) * torch.tensor(
        [3.0, 0.0, 4.0])).item() == pytest.approx(5.0)


@pytest.mark.parametrize("case", ["similarity", "noisy", "reflection"])
def test_procrustes_align_matches_jax(rng, case):
    """A similarity transform of the GT (aligned exactly), a noisy copy,
    and a mirrored copy, whose cross-covariance has det(U·Vᵀ) = −1 so the
    determinant fix must keep R a rotation."""
    gt = rng.normal(size=(5, 22, 3)).astype(np.float32)
    R = Rotation.from_euler("xyz", rng.normal(size=(3,))).as_matrix()
    pred = {"similarity": lambda: 1.7 * gt @ R.T + np.asarray([0.3, -1.0, 2.0]),
            "noisy": lambda: gt + rng.normal(size=gt.shape) * 0.1,
            "reflection": lambda: gt * np.asarray([-1.0, 1.0, 1.0]) @ R.T}[case]()
    pred = pred.astype(np.float32)
    got = tm.procrustes_align(_t(pred), _t(gt)).numpy()
    want = np.asarray(jm.procrustes_align(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    err = tm.pa_mpjpe(_t(pred), _t(gt)).item()
    np.testing.assert_allclose(err, float(jm.pa_mpjpe(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-5, atol=1e-6)
    if case == "similarity":
        assert err < 1e-4
    if case == "reflection":
        # the fix keeps a rotation: a mirror image is not aligned away
        assert err > 0.1
        pc = pred - pred.mean(1, keepdims=True)
        gc = gt - gt.mean(1, keepdims=True)
        U, _, Vt = np.linalg.svd(np.einsum("nji,njk->nik", gc, pc))
        assert (np.linalg.det(U @ Vt) < 0).all()


def test_canonical_joints_matches_jax(smplx_pair, rng):
    jsmplx, tsmplx = smplx_pair
    betas = rng.normal(size=(6, 10)).astype(np.float32) * 0.5
    rm = _rotmats(rng, (6, 22))
    got = tm.canonical_joints(tsmplx, _t(betas), _t(rm)).numpy()
    want = np.asarray(jm.canonical_joints(jsmplx, jnp.asarray(betas), jnp.asarray(rm)))
    assert got.shape == (6, 22, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_twoview_eval_metrics_match_jax(smplx_pair, rng):
    """Both sides at zero betas (the reference's quirk): the betas given
    change nothing, the root is the SMPL-X global_orient."""
    jsmplx, tsmplx = smplx_pair
    N = 4
    args = (_rotmats(rng, (N, 2, 22)), rng.normal(size=(N, 2, 10)).astype(np.float32),
            rng.normal(size=(N, 2, 3)).astype(np.float32), _rotmats(rng, (N, 21)),
            _rotmats(rng, (N, 2)), rng.normal(size=(N, 10)).astype(np.float32),
            rng.normal(size=(N, 2, 3)).astype(np.float32))
    want = jm.twoview_eval_metrics(jsmplx, *map(jnp.asarray, args))
    got = tm.twoview_eval_metrics(tsmplx, *map(_t, args))
    _check(got, want, 1e-5)
    other = list(args)
    other[1], other[5] = other[1] * 0 + 7.0, other[5] * 0 - 3.0
    other = tm.twoview_eval_metrics(tsmplx, *map(_t, other))
    assert all(torch.equal(other[k], got[k]) for k in got)
    # a perfect prediction (both views' body poses the GT's) scores 0
    rm = args[0].copy()
    rm[:, 1, 1:] = rm[:, 0, 1:]
    perfect = tm.twoview_eval_metrics(tsmplx, _t(rm), _t(args[1]), _t(args[2]),
                                      _t(rm[:, 0, 1:]), _t(rm[:, :, 0]), _t(args[5]),
                                      _t(args[2]))
    assert all(v.item() < 1e-4 for v in perfect.values()), perfect


def test_h36m_eval_metrics_match_jax(smplx_pair, rng):
    """Identity-root SMPL-X, then R_root·j + t into the camera frame."""
    jsmplx, tsmplx = smplx_pair
    N = 3
    args = (_rotmats(rng, (N, 2, 22)), rng.normal(size=(N, 2, 10)).astype(np.float32) * 0.5,
            rng.normal(size=(N, 2, 3)).astype(np.float32) + np.asarray([0, 0, 5.0], np.float32),
            rng.normal(size=(N, 2, 17, 3)).astype(np.float32) + np.asarray([0, 0, 5.0],
                                                                          np.float32))
    want = jm.h36m_eval_metrics(jsmplx, *map(jnp.asarray, args))
    _check(tm.h36m_eval_metrics(tsmplx, *map(_t, args)), want, 1e-5)
