"""Port parity: quantization-aware training (airpose_tpu_torch.ops.qat vs
airpose_tpu.ops.qat on the same numpy kernels and activations, on the CPU).

Tolerance: the fake-quantized values equal JAX's to 1 f32 ulp of the
quantization step (atol 1e-6 · max|x|: both divide, round half to even
and multiply in f32); the straight-through gradients are exactly the
incoming gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.ops import qat as jqat
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu_torch.models import AirPoseTwoView
from airpose_tpu_torch.ops import qat as tqat


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("levels", [127.0, 7.0])
def test_fake_quant_weight_matches_jax(rng, levels):
    k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(k), levels))
    w = _oihw(k).requires_grad_(True)
    got = tqat.fake_quant_weight(w, levels)
    np.testing.assert_allclose(got.detach().numpy(), want.transpose(3, 2, 0, 1),
                               atol=1e-6 * np.abs(k).max(), rtol=0)
    # per output channel (torch's first axis): at most 2·levels + 1 values
    for c in (0, 5):
        assert len(torch.unique(got[c].detach())) <= 2 * levels + 1
    # straight-through: the gradient is the incoming one, exactly
    g = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32))
    (dw,) = torch.autograd.grad(got, w, g)
    assert torch.equal(dw, g)


@pytest.mark.parametrize("scale", [None, 0.02], ids=["dynamic", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_quant_act_matches_jax(rng, scale, dtype):
    x = (rng.normal(size=(2, 6, 6, 8)) * 2).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jqat.fake_quant_act(jnp.asarray(x, jdt), 127.0, scale=scale)
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    got = tqat.fake_quant_act(xt, 127.0, scale=scale)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=1e-6 * np.abs(x).max(), rtol=0)
    if scale is not None:  # the frozen grid clips at ±127 steps (rounded to dtype)
        top = torch.tensor(127 * scale, dtype=torch.float32).to(dtype).float().item()
        assert got.detach().float().abs().max().item() == top
    g = torch.ones_like(xt)
    (dx,) = torch.autograd.grad(got, xt, g)
    assert torch.equal(dx, g)


def test_fake_quant_trunk_params_matches_jax(rng):
    """The same tensors are quantized in both packages: the residual-stage
    conv kernels of the trunk, not the stem, BatchNorm or the heads."""
    model = AirPoseTwoView(seed=0)
    params = dict(model.named_parameters())
    got = tqat.fake_quant_trunk_params(params, 15.0)
    changed = {n for n in params if got[n] is not params[n]}
    assert changed == {n for n in params if n.startswith("trunk.layer")
                       and (".conv" in n or ".downsample.0." in n)}
    assert len(changed) == 52 and "trunk.conv1.weight" not in changed

    sd = {"model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k): v
          for k, v in model.state_dict().items()}
    jparams = convert_reference_checkpoint(sd)["params"]  # random kernels, numpy

    def leaves(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    before = leaves(jparams)
    after = leaves(jax.jit(lambda p: jqat.fake_quant_trunk_params(p, 15.0))(jparams))
    jchanged = {p for p in before if not np.array_equal(after[p], before[p])}
    assert len(jchanged) == len(changed) and "trunk/conv1/kernel" not in jchanged
    # one carried kernel quantizes alike on both sides
    k = rng.normal(size=(1, 1, 64, 256)).astype(np.float32)
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(k), 15.0)).transpose(3, 2, 0, 1)
    got_k = tqat.fake_quant_trunk_params({"trunk.layer1.0.conv3.weight": _oihw(k)}, 15.0)
    np.testing.assert_allclose(got_k["trunk.layer1.0.conv3.weight"].numpy(), want,
                               atol=1e-6 * np.abs(k).max(), rtol=0)


@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_bottleneck_act_fq_matches_flax(rng, frozen):
    """Activation QAT inside a stride-2 projection block (eval mode): every
    conv input fake-quantized, the projection under its own ``proj`` site,
    the identity path unquantized; output within 1e-4 of its largest entry
    (f32 convolutions in other orders)."""
    from airpose_tpu.models.resnet import Bottleneck as JBottleneck
    from airpose_tpu_torch.models.resnet import Bottleneck

    cin, planes = 16, 8
    x = np.abs(rng.normal(size=(2, 8, 8, cin))).astype(np.float32)
    sites = ("conv1", "conv2", "conv3", "proj")
    scales = {f"layer2_0/{s}": float(v) for s, v in zip(sites, rng.uniform(0.01, 0.03, 4))}
    act_fq = (15.0, scales) if frozen else 15.0
    jblk = JBottleneck(planes=planes, stride=2, project=True, act_fq=act_fq,
                       name="layer2_0")
    variables = jax.tree.map(np.array, JBottleneck(planes=planes, stride=2, project=True)
                             .init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jax.jit(jblk.apply)(variables, jnp.asarray(x)))

    blk = Bottleneck(cin, planes, stride=2, project=True, act_fq=act_fq, site="layer2_0")
    p, st = variables["params"], variables["batch_stats"]
    sd = {f"{t}.weight": _oihw(p[j]["kernel"]) for j, t in (
        ("conv1", "conv1"), ("conv2", "conv2"), ("conv3", "conv3"),
        ("downsample_conv", "downsample.0"))}
    for j, t in (("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3"),
                 ("downsample_bn", "downsample.1")):
        sd.update({f"{t}.weight": torch.from_numpy(p[j]["scale"]),
                   f"{t}.bias": torch.from_numpy(p[j]["bias"]),
                   f"{t}.running_mean": torch.from_numpy(st[j]["mean"]),
                   f"{t}.running_var": torch.from_numpy(st[j]["var"]),
                   f"{t}.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    blk.load_state_dict(sd)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        plain = Bottleneck(cin, planes, stride=2, project=True)
        plain.load_state_dict(sd)
        unquantized = plain(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got - unquantized).max() > 1e-3 * np.abs(want).max()  # the grid acts
