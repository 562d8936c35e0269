"""Port parity of the model families (airpose_tpu_torch.models vs
airpose_tpu.models on the same numpy inputs and weights, on the CPU, f32):
the eval forwards of all five families, the weight carry of each family's
reference layout, the per-drone model's simultaneous view update and its
staged serving step, Int8Inference over the per-drone trunks, and the
``iters`` constructor argument.

Weights start from a seeded port model (a flax ResNet-50 init would take
~20 s a trunk), with BatchNorm statistics moved off (0, 1), and reach flax
through the reference state dict (convert_reference_checkpoint); the port
models under test load them back through state_dict_from_flax and
load_reference_state_dict. Tolerances: the eval forwards atol = rtol = 1e-4
(tests/test_torch_models.py's bounds for the same f32 trunk and IEF), the
staged steps 1e-5 (tests/test_models.py's), the weight carry exact, the int8
trunks' features exact on the carried int8 operands and the IEF on them
1e-4."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.models import MODEL_REGISTRY as JREGISTRY
from airpose_tpu.models import AirPoseTwoViewSepView as JSepView
from airpose_tpu.models import mean_init_state as jmean_init_state
from airpose_tpu.ops import int8_trunk as jq
from airpose_tpu.train.checkpoint import (convert_reference_checkpoint,
                                         export_reference_checkpoint)
from airpose_tpu_torch.models import (MODEL_REGISTRY, AirPoseTwoViewSep, AirPoseTwoViewSepView,
                                      family_init_args, mean_init_state)
from airpose_tpu_torch.ops import int8_trunk as tq
from airpose_tpu_torch.train.checkpoint import (int8_operands_from_jax,
                                                load_reference_state_dict,
                                                state_dict_from_flax)

B, IMG = 2, 64
FAMILIES = list(MODEL_REGISTRY)
SEP = "copenet_twoview_sep"


@pytest.fixture(autouse=True)
def _drop_tmp_path(request):
    """Deletes each test's tmp_path when it ends: its checkpoints (~100-400
    MB each) would otherwise stay in the base temps pytest keeps."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def reference_sd(model, family):
    """The port model's state dict under the reference net's keys."""
    out = {}
    for k, v in model.state_dict().items():
        head, rest = k.split(".", 1) if "." in k else (k, k)
        if family == SEP:  # trunk{v}.*, core{v}.* (its buffers too)
            out[f"model.copenet{head[-1]}.{rest}"] = v
        else:
            out["model." + (rest if head in ("trunk", "core") else k)] = v
    return out


@pytest.fixture(scope="module")
def carried():
    """Per family: the seeded port model (BN statistics perturbed), its
    weights as flax variables, and a port model of another seed that
    loaded them back from state_dict_from_flax."""
    rng = np.random.default_rng(0)
    out = {}
    for i, family in enumerate(FAMILIES):
        model = MODEL_REGISTRY[family](seed=i)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(torch.from_numpy(rng.normal(0, 0.05, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.mul_(torch.from_numpy(rng.uniform(0.8, 1.2, buf.shape).astype(np.float32)))
        variables = convert_reference_checkpoint(reference_sd(model, family), family)
        port = MODEL_REGISTRY[family](seed=100 + i)
        load_reference_state_dict(port, state_dict_from_flax(variables, family), family)
        out[family] = (model, variables, port)
    return out


def _inputs(family, seed, img=IMG):
    """family_init_args's arguments at B = 2, img², moved off zero."""
    rng = np.random.default_rng(seed)
    return [a.numpy() + (rng.normal(size=a.shape) * (0.5 if a.ndim >= 4 else 0.1)
                         ).astype(np.float32)
            for a in family_init_args(family, B, img, "cpu")]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_eval_matches_flax(carried, family):
    _, variables, port = carried[family]
    args = _inputs(family, 1)
    want = jax.jit(JREGISTRY[family]().apply)(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_weight_carry_round_trip(carried, family):
    """convert_reference_checkpoint → state_dict_from_flax →
    load_reference_state_dict (strict) gives back every tensor exactly,
    the mean-parameter buffers included; a missing key raises."""
    model, variables, port = carried[family]
    want, got = model.state_dict(), port.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd = state_dict_from_flax(variables, family)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(port, {k: v for k, v in sd.items() if "fc2" not in k}, family)
    with pytest.raises(ValueError, match="unknown model family"):
        state_dict_from_flax(variables, "spin")


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_from_flax_equals_export(carried, family, tmp_path):
    variables = carried[family][1]
    path = export_reference_checkpoint(variables, family, str(tmp_path / "m.ckpt"))
    want = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
    got = state_dict_from_flax(variables, family)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # the export loads into the port model of the family, deccam live only in hmr/muhmr
    model = MODEL_REGISTRY[family](seed=9)
    load_reference_state_dict(model, {"state_dict": want}, family)
    assert hasattr(model.core0 if family == SEP else model.core, "deccam") == (
        family in ("hmr", "muhmr"))


def test_sep_views_update_from_the_same_pre_step_state(carried):
    """One IEF step of the per-drone model: each view's core reads both
    views' state from before the step (not view 0's fresh shape, as the
    reference's sequential forward would give view 1)."""
    port = carried[SEP][2]
    rng = np.random.default_rng(2)
    xf, bb, pos = (torch.from_numpy(rng.normal(size=(B, 2, n)).astype(np.float32))
                   for n in (2048, 3, 3))
    with torch.no_grad():
        out = port.from_features(xf, bb, pos, iters=1)
        pose, shape = mean_init_state((B, 2), "cpu")[:2]
        pose = torch.cat([pos, pose], dim=-1)
        for v, core in enumerate((port.core0, port.core1)):
            o = 1 - v
            dp, ds = core(torch.cat([xf[:, v], bb[:, v], pose[:, v], shape[:, v],
                                     pose[:, o, 9:], shape[:, o]], dim=-1))
            torch.testing.assert_close(out.pose[:, v], pose[:, v] + dp, rtol=0, atol=0)
            torch.testing.assert_close(out.betas[:, v], shape[:, v] + ds, rtol=0, atol=0)
        # the sequential order (view 1 after view 0's shape moved) differs
        seq = port.core1(torch.cat([xf[:, 1], bb[:, 1], pose[:, 1], shape[:, 1], pose[:, 0, 9:],
                                    out.betas[:, 0]], dim=-1))[1]
        assert (shape[:, 1] + seq - out.betas[:, 1]).abs().max() > 0


def test_sep_view_regress_step_matches_jax_and_staged_equals_fused(carried):
    """AirPoseTwoViewSepView over the _sep weights: each view's trunk and
    regress_step against JAX's, and three staged rounds, each view from
    the same pre-round peer state, against the fused forward."""
    _, variables, port = carried[SEP]
    x, bb, pos = (torch.from_numpy(a) for a in _inputs(SEP, 3))
    views = []
    for v in (0, 1):
        view = AirPoseTwoViewSepView(view=v, seed=50)
        view.load_state_dict(port.state_dict())
        views.append(view)
    with torch.no_grad():
        fused = port(x, bb, pos)
        xf = torch.stack([views[v](x[:, v]) for v in (0, 1)], dim=1)
        pose0, shape = mean_init_state((B, 2), "cpu")[:2]
        pose = torch.cat([pos, pose0], dim=-1)
        for _ in range(3):
            steps = [views[v].regress_step(xf[:, v], bb[:, v], pose[:, v], shape[:, v],
                                           pose[:, 1 - v, 9:], shape[:, 1 - v]) for v in (0, 1)]
            pose = torch.stack([s[0] for s in steps], dim=1)
            shape = torch.stack([s[1] for s in steps], dim=1)
    torch.testing.assert_close(pose, fused.pose, rtol=0, atol=1e-5)
    torch.testing.assert_close(shape, fused.betas, rtol=0, atol=1e-5)
    rng = np.random.default_rng(4)
    args = [rng.normal(size=(B, n)).astype(np.float32) for n in (2048, 3, 135, 10, 126, 10)]
    for v in (0, 1):
        jview = JSepView(view=v)
        want = jview.apply(variables, *map(jnp.asarray, args), method=JSepView.regress_step)
        with torch.no_grad():
            got = views[v].regress_step(*map(torch.from_numpy, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        jxf = jview.apply(variables, jnp.asarray(x[:, v].numpy()))
        np.testing.assert_allclose(xf[:, v].numpy(), np.asarray(jxf), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="view"):
        AirPoseTwoViewSepView(view=2)


def test_int8_inference_sep_quantizes_each_trunk(carried):
    """Int8Inference over the per-drone model: one quantization and one
    calibration table per trunk, both on the same sample crops, each the
    table of its own trunk; view v's crops go through trunk v; iters
    reaches from_features; clip_report merges the trunks."""
    port = carried[SEP][2]
    x, bb, pos = (torch.from_numpy(a) for a in _inputs(SEP, 5))
    x = x * 0.3
    shim = tq.Int8Inference(port, x[0])
    assert len(shim.qparams) == len(shim.act_scales) == 2
    for trunk, qp, scales in zip((port.trunk0, port.trunk1), shim.qparams, shim.act_scales):
        want = tq.quantize_trunk_params(trunk.state_dict())
        assert torch.equal(qp["layer3_2"]["conv2"]["wq"], want["layer3_2"]["conv2"]["wq"])
        assert scales == tq.calibrate_act_scales(want, x[0])
    assert shim.act_scales[0] != shim.act_scales[1]
    xf = shim._features(x)
    for v in (0, 1):
        torch.testing.assert_close(xf[:, v], tq.resnet50_int8_infer(
            shim.qparams[v], x[:, v], shim.act_scales[v]), rtol=0, atol=0)
    got = shim.apply(x, bb, pos, iters=1)
    with torch.no_grad():
        one = port.from_features(xf, bb, pos, iters=1)
    torch.testing.assert_close(got.pose, one.pose, rtol=0, atol=0)
    rates = shim.clip_report(x)
    assert len(rates) == 104 and all(k.startswith(("trunk0/", "trunk1/")) for k in rates)
    with pytest.raises(ValueError, match="inference-only"):
        shim.apply(x, bb, pos, train=True)


def test_int8_inference_sep_matches_jax(carried):
    """On the JAX shim's int8 operands, carried per trunk by
    int8_operands_from_jax, the port's per-drone Int8Inference gives each
    view's features equal to JAX's bit for bit, the IEF within 1e-4 (with
    and without iters) and the same clip rates."""
    _, variables, port = carried[SEP]
    x, bb, pos = _inputs(SEP, 5)
    x = x * 0.3
    jshim = jq.Int8Inference(JREGISTRY[SEP](), variables, jnp.asarray(x[0]))
    shim = tq.Int8Inference(port, torch.from_numpy(x[0]))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ops = [int8_operands_from_jax(np_tree(jshim.qparams[v]), jshim.act_scales[v])
           for v in (0, 1)]
    shim.qparams, shim.act_scales = [o[0] for o in ops], [o[1] for o in ops]

    images = torch.from_numpy(x)
    np.testing.assert_array_equal(shim._features(images).numpy(),
                                  np.asarray(jshim._features(jnp.asarray(x))))
    for iters in (None, 1):
        got = shim.apply(images, torch.from_numpy(bb), torch.from_numpy(pos), iters=iters)
        want = jshim.apply(variables, *map(jnp.asarray, (x, bb, pos)), iters=iters)
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4, rtol=1e-4)
    rates, want_rates = shim.clip_report(images), jshim.clip_report(jnp.asarray(x))
    assert sorted(rates) == sorted(want_rates)
    for k in rates:
        assert rates[k] == pytest.approx(want_rates[k], abs=1e-6), k


def test_sep_act_fq_gives_each_trunk_its_table():
    """``act_fq=(levels, (table0, table1))`` gives each per-drone trunk its
    own frozen activation-scale table (airpose.py:371-375); a bare grid
    goes to both trunks."""
    t0, t1 = {"layer1_0/conv1": 0.1}, {"layer1_0/conv1": 0.2}
    split = AirPoseTwoViewSep(act_fq=(15.0, (t0, t1)))
    for trunk, table in ((split.trunk0, t0), (split.trunk1, t1)):
        assert all(b.act_fq == (15.0, table) for layer in (trunk.layer1, trunk.layer4)
                   for b in layer)
    shared = AirPoseTwoViewSep(act_fq=15.0)
    assert shared.trunk0.layer4[2].act_fq == shared.trunk1.layer4[2].act_fq == 15.0


@pytest.mark.parametrize("family", FAMILIES)
def test_iters_constructor_argument(family):
    """``iters`` set at construction is the IEF step count unless a call
    passes its own, as in the JAX modules (default 3)."""
    one, default = (MODEL_REGISTRY[family](seed=3, **kw) for kw in ({"iters": 1}, {}))
    assert (one.iters, default.iters) == (1, 3) and JREGISTRY[family]().iters == 3
    args = [torch.from_numpy(a) for a in _inputs(family, 6)]
    with torch.no_grad():
        got = one(*args)
        want = default(*args, iters=1)
        three = default(*args)
    for g, w, t in zip(got, want, three):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not torch.equal(g, t)


def test_mean_init_state_matches_jax():
    got = mean_init_state((2, 3), "cpu")
    want = jmean_init_state((2, 3))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
