"""Port parity: ResNet-50 trunk, AirPoseTwoView and the flax → torch weight
carry (airpose_tpu_torch vs airpose_tpu on the same numpy inputs and
weights, on the CPU, f32)."""

import filecmp
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.models import AirPoseTwoView as JAirPoseTwoView
from airpose_tpu.train.checkpoint import (convert_reference_checkpoint,
                                         export_reference_checkpoint)
from airpose_tpu_torch.models import AirPoseTwoView
from airpose_tpu_torch.models.regressor import MEAN_PARAMS
from airpose_tpu_torch.train.checkpoint import (load_reference_state_dict,
                                                state_dict_from_flax)

B, IMG = 2, 64


@pytest.fixture(scope="module")
def jax_twoview():
    """Flax variables converted from a seeded port model's reference state
    dict, with BN statistics moved off (0, 1) so that running-stat BatchNorm
    is not the identity (a flax init would take ~20 s here)."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in AirPoseTwoView(seed=0).state_dict().items():
        if k.endswith("running_mean"):
            v = v + torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = v * torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
        sd["model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k)] = v
    return JAirPoseTwoView(), convert_reference_checkpoint(sd)


@pytest.fixture(scope="module")
def port_twoview(jax_twoview):
    model = AirPoseTwoView(seed=1)
    load_reference_state_dict(model, state_dict_from_flax(jax_twoview[1]))
    return model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 2, IMG, IMG, 3)).astype(np.float32) * 0.5
    bb = rng.normal(size=(B, 2, 3)).astype(np.float32) * 0.1
    pos = np.asarray([[[0.1, -0.2, 0.5], [0.0, 0.3, 0.6]]] * B, np.float32)
    return x, bb, pos


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_trunk_f32_matches_flax(jax_twoview, port_twoview):
    model, variables = jax_twoview
    x = _inputs()[0].reshape(B * 2, IMG, IMG, 3)
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.extract_features(x)))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_twoview.extract_features(torch.from_numpy(x)).numpy()
    assert got.shape == (B * 2, 2048)
    assert _rel(got, want) < 1e-4


def test_twoview_eval_matches_flax(jax_twoview, port_twoview):
    model, variables = jax_twoview
    x, bb, pos = _inputs(1)
    want = jax.jit(model.apply)(variables, jnp.asarray(x), jnp.asarray(bb), jnp.asarray(pos))
    with torch.no_grad():
        got = port_twoview(torch.from_numpy(x), torch.from_numpy(bb), torch.from_numpy(pos))
    assert got.pose.shape == (B, 2, 135) and got.betas.shape == (B, 2, 10)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), atol=1e-4, rtol=1e-4)


def test_regress_step_matches_flax(jax_twoview, port_twoview, rng):
    model, variables = jax_twoview
    xf, bb, own_pose = (rng.normal(size=(B, n)).astype(np.float32) for n in (2048, 3, 135))
    own_shape, peer_shape = (rng.normal(size=(B, 10)).astype(np.float32) for _ in range(2))
    peer_art = rng.normal(size=(B, 126)).astype(np.float32)
    args = (xf, bb, own_pose, own_shape, peer_art, peer_shape)
    want = model.apply(variables, *map(jnp.asarray, args),
                       method=lambda m, *a: m.regress_step(*a))
    with torch.no_grad():
        got = port_twoview.regress_step(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_state_dict_from_flax_equals_export(jax_twoview, tmp_path):
    variables = jax_twoview[1]
    path = export_reference_checkpoint(variables, "copenet_twoview", str(tmp_path / "m.ckpt"))
    want = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
    got = state_dict_from_flax(variables)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_load_reference_state_dict_strict(jax_twoview, tmp_path):
    path = export_reference_checkpoint(jax_twoview[1], "copenet_twoview", str(tmp_path / "m.ckpt"))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = AirPoseTwoView(seed=5)
    load_reference_state_dict(model, ckpt)  # strict=True: any missing/extra key raises
    sd = state_dict_from_flax(jax_twoview[1])
    assert torch.equal(model.trunk.layer3[2].conv2.weight, sd["model.layer3.2.conv2.weight"])
    assert torch.equal(model.core.decpose.weight, sd["model.decpose.weight"])
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(model, {k: v for k, v in sd.items() if "fc2" not in k})


def test_mean_params_asset_is_the_jax_copy():
    jax_copy = Path(__file__).parents[1] / "airpose_tpu/data/assets/smpl_mean_params.npz"
    assert filecmp.cmp(MEAN_PARAMS, jax_copy, shallow=False)


def test_init_follows_jax_initializers():
    model = AirPoseTwoView(seed=3)
    again = AirPoseTwoView(seed=3)
    assert torch.equal(model.core.fc1.weight, again.core.fc1.weight)  # seeded generator
    w = model.trunk.layer1[0].conv2.weight  # (64, 64, 3, 3): fan_out 576
    assert abs(w.std().item() - math.sqrt(2 / 576)) < 0.05 * math.sqrt(2 / 576)
    head = model.core.decpose.weight  # xavier-uniform, gain 0.01
    assert head.abs().max().item() <= 0.01 * math.sqrt(6 / (1024 + 135))
    assert model.init_pose.shape == (1, 144) and model.init_cam.shape == (1, 3)
