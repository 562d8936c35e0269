"""Port parity: BN folding, the fused layer1 stage and the bf16 fused-layer1
trunk (airpose_tpu_torch vs airpose_tpu with its Pallas kernel in interpret
mode, same numpy inputs and weights, on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from airpose_tpu.models.resnet import ResNet50 as JResNet50
from airpose_tpu.ops import fused_bottleneck as jfb
from airpose_tpu.train.checkpoint import convert_resnet_torch_to_flax
from airpose_tpu_torch.models.resnet import ResNet50
from airpose_tpu_torch.ops import fused_bottleneck as tfb

IMG = 64  # 16×16 maps after the stem


@pytest.fixture(scope="module")
def trunks():
    """A seeded port trunk with BN statistics moved off (0, 1) and the same
    weights as flax trunk variables; the (jitted) flax trunk runs in bf16."""
    rng = np.random.default_rng(0)
    trunk = ResNet50(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    sd = trunk.state_dict()
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    trunk.load_state_dict(sd)
    jtrunk = jax.jit(JResNet50(dtype=jnp.bfloat16).apply, static_argnames="part")
    return trunk, jtrunk, convert_resnet_torch_to_flax(sd)


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32) * 0.3


def test_fold_bn_matches_conv_bn(rng):
    k = torch.from_numpy(rng.normal(size=(16, 8, 3, 3)).astype(np.float32) * 0.2)
    g, v = (torch.from_numpy(rng.uniform(lo, hi, 16).astype(np.float32))
            for lo, hi in ((0.5, 1.5), (0.5, 2.0)))
    b, m = (torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.1) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(3, 8, 5, 5)).astype(np.float32))

    want = F.batch_norm(F.conv2d(x, k, padding=1), m, v, g, b, False, 0.0, 1e-5)
    kf, bf = tfb.fold_bn_into_conv(k, g, b, m, v)
    torch.testing.assert_close(F.conv2d(x, kf, bf, padding=1), want, atol=1e-5, rtol=1e-5)


def test_stage1_params_equal_jax(trunks):
    trunk, _, variables = trunks
    want = jfb.stage1_params_from_variables(variables)
    got = tfb.stage1_params_from_state_dict(trunk.state_dict())
    it = iter(want)
    for b, blk in enumerate(got):
        for k in ("w1", "b1", "w2", "b2", "w3", "b3") + (("wp", "bp") if b == 0 else ()):
            w = np.asarray(next(it).astype(jnp.float32))
            if k == "w2":  # (9, Cin, Cout) → (Cout, 9·Cin)
                w = w.transpose(2, 0, 1).reshape(w.shape[2], -1)
            elif w.ndim == 2:  # (Cin, Cout) → (Cout, Cin)
                w = w.T
            # numpy and torch may round the f32 folding one ulp apart, which
            # can move a bf16 weight by one bf16 ulp
            rtol = 2.0 ** -8 if blk[k].dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(blk[k].float().numpy(), w, rtol=rtol, atol=0,
                                       err_msg=f"{b}/{k}")


def test_fused_stage1_reference_matches_pallas(trunks):
    trunk, jtrunk, variables = trunks
    stem = jtrunk(variables, jnp.asarray(_images(1)), part="stem")  # (2, 16, 16, 64)
    want = np.asarray(jfb.fused_stage1(stem.astype(jnp.bfloat16),
                                       jfb.stage1_params_from_variables(variables),
                                       interpret=True), np.float32)
    x = torch.from_numpy(np.asarray(stem, np.float32)).to(torch.bfloat16)
    got = tfb.fused_stage1(x, tfb.stage1_params_from_state_dict(trunk.state_dict()))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)
    assert float(np.abs(want).mean()) > 1e-3


def test_resnet50_fused_infer_bf16_matches_flax(trunks):
    trunk, jtrunk, variables = trunks
    x = _images(2)
    want = np.asarray(jtrunk(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tfb.resnet50_fused_infer(trunk, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    # the JAX package's own end-to-end bound for its fused trunk
    # (tests/test_fused_bottleneck.py): 13 further random-weight bf16 blocks
    # amplify rounding-point differences
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.1
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.995
