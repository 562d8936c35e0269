"""The int8 conv's requant epilogue (``qscale``) and the static int8 trunk
that quantizes each conv's output in that epilogue, on the CPU (the conv
kernel's plain version), against torch ``_quantize_act`` on the old bf16
output and against the JAX package's ``_qconv`` + ``_quantize_act``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.ops import int8_trunk as jq
from airpose_tpu_torch.models.resnet import ResNet50
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.ops import int8_trunk as tq


def _conv_case(rng, ksize, stride, residual):
    """A bf16 map, int8 weights, a static input scale, and the optional bf16
    residual of one conv of the trunk, as numpy."""
    cin, cout, N, H, W = 64, 96, 2, 9, 13
    x = np.asarray(jnp.asarray(rng.normal(size=(N, H, W, cin)).astype(np.float32) * 2.0,
                               jnp.bfloat16), np.float32)
    wq = rng.integers(-127, 128, size=(ksize, ksize, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.5, 1.5, cout).astype(np.float32) * 1e-3
    b = rng.normal(size=cout).astype(np.float32) * 0.1
    s = float(np.abs(x).max() / 100.0)
    ho = (H + 2 * (ksize // 2) - ksize) // stride + 1
    wo = (W + 2 * (ksize // 2) - ksize) // stride + 1
    res = rng.normal(size=(N, ho, wo, cout)).astype(np.float32) if residual else None
    return x, wq, ws, b, s, res


def _port_conv(wq, ws, b):
    cout = wq.shape[-1]
    return {"wq": torch.from_numpy(wq.transpose(3, 0, 1, 2).reshape(cout, -1).copy()),
            "ws": torch.from_numpy(ws), "b": torch.from_numpy(b)}


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "bf16_residual"])
@pytest.mark.parametrize("ksize,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_requant_epilogue_equals_torch_quantize(rng, ksize, stride, residual):
    """The epilogue's int8 at the next conv's scale equals torch
    _quantize_act of the old epilogue's bf16 output, bit for bit; the dual
    mode also returns that bf16 output unchanged. The next scale puts 10%
    of the values past the clip."""
    x, wq, ws, b, s, res = _conv_case(rng, ksize, stride, residual)
    conv = _port_conv(wq, ws, b)
    xq, xs = tq._quantize_act(torch.from_numpy(x).to(torch.bfloat16), s)
    r = None if res is None else torch.from_numpy(res).to(torch.bfloat16)
    old = tq._conv_q(xq, xs * conv["ws"], conv, ksize, stride, relu=True, res=r)
    s_next = float(torch.quantile(old.float().abs().flatten(), 0.9)) / 127.0
    want, _ = tq._quantize_act(old, s_next)
    got = tq._conv_q(xq, xs * conv["ws"], conv, ksize, stride, relu=True, res=r, qscale=s_next,
                     out_dtype=torch.int8)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (want.abs() == 127).float().mean() > 0.05, "the clip is not exercised"
    h, q = tq._conv_q(xq, xs * conv["ws"], conv, ksize, stride, relu=True, res=r, qscale=s_next)
    assert torch.equal(h, old) and torch.equal(q, want)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "bf16_residual"])
@pytest.mark.parametrize("ksize,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_requant_epilogue_matches_jax(rng, ksize, stride, residual):
    """The same int8 equals JAX's _qconv (relu, then the bf16 residual add)
    followed by JAX's _quantize_act at the next scale, bit for bit."""
    x, wq, ws, b, s, res = _conv_case(rng, ksize, stride, residual)
    y = jq._qconv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(ws),
                  jnp.asarray(b), stride=stride, act_scale=jnp.float32(s))
    y = jax.nn.relu(y if res is None else y + jnp.asarray(res, jnp.bfloat16))
    s_next = float(np.quantile(np.abs(np.asarray(y, np.float32)), 0.9) / 127.0)
    want, _ = jq._quantize_act(y, jnp.float32(s_next))
    xq, xs = tq._quantize_act(torch.from_numpy(x).to(torch.bfloat16), s)
    r = None if res is None else torch.from_numpy(res).to(torch.bfloat16)
    conv = _port_conv(wq, ws, b)
    got = tq._conv_q(xq, xs * conv["ws"], conv, ksize, stride, relu=True, res=r,
                     qscale=s_next, out_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def trunk_tables():
    """A seeded trunk with BN statistics moved off (0, 1), quantized and
    calibrated on two 32² crops; the crops themselves."""
    rng = np.random.default_rng(4)
    sd = ResNet50(generator=torch.Generator().manual_seed(4)).state_dict()
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    qp = tq.quantize_trunk_params(sd)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    return qp, tq.calibrate_act_scales(qp, x), x


@pytest.mark.parametrize("case,calls", [
    ("static", 1),             # the stem's output only
    ("proj_scale_differs", 2),  # layer1_0's projection input quantized on its own
    ("stages_3_4", 1),          # the int8 stages' input, after bf16 layers 1-2
    ("dynamic", 52),            # every conv input, as calibration runs it
    ("clip_rates", 52),         # every conv input, on the bf16 map
])
def test_torch_quantize_calls(trunk_tables, case, calls):
    qp, scales, x = trunk_tables
    assert scales["layer1_0/proj"] == scales["layer1_0/conv1"]
    _build.counts.clear()
    if case == "dynamic":
        tq.resnet50_int8_infer(qp, x)
    elif case == "clip_rates":
        tq.calibration_clip_rates(qp, scales, x)
    elif case == "stages_3_4":
        tq.resnet50_int8_infer(qp, x, scales, int8_stages=(3, 4))
    else:
        if case == "proj_scale_differs":
            scales = dict(scales)
            scales["layer1_0/proj"] *= 1.25
        tq.resnet50_int8_infer(qp, x, scales)
    assert _build.counts["quantize_act"] == calls


@pytest.mark.parametrize("stages", [(1, 2, 3, 4), (3, 4)])
def test_static_trunk_equals_per_conv_quantize(trunk_tables, stages):
    """The static trunk with the quantization folded into the conv epilogues
    gives the same features, bit for bit, as the same trunk quantizing every
    conv input in torch (the clip-rate path), with or without a differing
    projection scale."""
    qp, scales, x = trunk_tables
    for table in (scales, dict(scales, **{"layer1_0/proj": scales["layer1_0/proj"] * 1.25})):
        folded = tq.resnet50_int8_infer(qp, x, table, int8_stages=stages)
        per_conv = tq.resnet50_int8_infer(qp, x, table, int8_stages=stages, _clip_collect={})
        assert torch.equal(folded, per_conv)
