"""The port's checkpoints against the JAX package (CPU): CheckpointManager's
round trip is bit for bit (step, parameters, BatchNorm statistics, AMSGrad
state), resume on an empty directory, best_val.json across managers; a
port checkpoint loads in airpose_tpu.train.checkpoint.load_model_variables
and JAX's export_reference_checkpoint loads in the port's, for all five
families, the two eval forwards within tests/test_torch_families.py's
atol = rtol = 1e-4; and the ImageNet warm start equals JAX's exactly.

Weights start from seeded port models with BatchNorm statistics moved off
(0, 1); they reach flax through convert_reference_checkpoint (a flax
ResNet-50 init takes ~20 s a trunk)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.models import MODEL_REGISTRY as JREGISTRY
from airpose_tpu.train import checkpoint as jckpt
from airpose_tpu_torch.models import MODEL_REGISTRY, family_init_args
from airpose_tpu_torch.models.resnet import ResNet50
from airpose_tpu_torch.train import checkpoint as tckpt
from airpose_tpu_torch.train.state import create_train_state, model_variables

FAMILIES = [f for f in MODEL_REGISTRY if f in JREGISTRY]   # the families both packages have


@pytest.fixture(autouse=True)
def _drop_tmp_path(request):
    """Deletes each test's tmp_path when it ends: its checkpoints (~100-400
    MB each) would otherwise stay in the base temps pytest keeps."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores, and a worker whose torch uses
    every core oversubscribes them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Each test's files go when it ends: a checkpoint is ~430 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def perturbed_model(family, seed):
    """A seeded port model of ``family`` with its BN statistics moved."""
    rng = np.random.default_rng(seed)
    model = MODEL_REGISTRY[family](seed=seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.add_(torch.from_numpy(rng.normal(0, 0.05, buf.shape).astype(np.float32)))
        elif name.endswith("running_var"):
            buf.mul_(torch.from_numpy(rng.uniform(0.8, 1.2, buf.shape).astype(np.float32)))
    return model


def inputs(family, seed=1):
    rng = np.random.default_rng(seed)
    return [a.numpy() + (rng.normal(size=a.shape) * (0.5 if a.ndim >= 4 else 0.1)
                         ).astype(np.float32)
            for a in family_init_args(family, 2, 64, "cpu")]


def assert_forwards_agree(port_model, jvariables, family):
    args = inputs(family)
    want = jax.jit(JREGISTRY[family]().apply)(jvariables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port_model(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def trained_state(family, seed):
    """A TrainState whose every tensor (parameters, BN statistics, AMSGrad
    moments) and counter is moved off its initial value."""
    model = perturbed_model(family, seed)
    state, _ = create_train_state(model, 5e-5)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in state.params.values():
            t.add_(torch.randn(t.shape, generator=g) * 1e-3)
        for k in ("mu", "nu", "nu_max"):
            for t in state.opt_state[k].values():
                t.copy_(torch.rand(t.shape, generator=g))
    state.opt_state["count"] = 7
    state.step = 7
    return model, state


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_manager_round_trip_is_bit_exact(family, tmp_path):
    _, state = trained_state(family, 3)
    mgr = tckpt.CheckpointManager(str(tmp_path), family)
    mgr.save(state, "last")
    blob = torch.load(tmp_path / "last.ckpt", weights_only=True)
    assert blob["global_step"] == 7 and set(blob["optimizer"]) == {"count", "mu", "nu", "nu_max"}
    assert all(k.startswith("model.") for k in blob["state_dict"])
    assert all(v.dtype in (torch.float32, torch.int64) for v in blob["state_dict"].values())
    # the file is a reference state dict: a fresh model loads it strictly
    tckpt.load_reference_state_dict(MODEL_REGISTRY[family](seed=9), blob, family)

    fresh, _ = create_train_state(MODEL_REGISTRY[family](seed=4), 5e-5)
    got = tckpt.CheckpointManager(str(tmp_path), family).auto_resume(fresh)
    assert got is fresh and got.step == 7 and got.opt_state["count"] == 7
    for tree in ("params", "batch_stats"):
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(got, tree)[k], v), k
    for k in ("mu", "nu", "nu_max"):
        for n, v in state.opt_state[k].items():
            assert torch.equal(got.opt_state[k][n], v), (k, n)


def test_auto_resume_on_an_empty_directory_keeps_the_state(tmp_path):
    model = MODEL_REGISTRY["hmr"](seed=0)
    state, _ = create_train_state(model, 5e-5)
    before = {k: v.clone() for k, v in state.params.items()}
    mgr = tckpt.CheckpointManager(str(tmp_path / "new" / "checkpoints"), "hmr")
    assert mgr.restore(state) is None
    assert mgr.auto_resume(state) is state and state.step == 0
    assert all(torch.equal(state.params[k], v) for k, v in before.items())
    assert mgr.best_val == float("inf")


def test_best_val_survives_managers_and_restore_checks_the_model(tmp_path):
    model = MODEL_REGISTRY["copenet_singleview"](seed=0)
    state, _ = create_train_state(model, 5e-5)
    mgr = tckpt.CheckpointManager(str(tmp_path), "copenet_singleview")
    mgr.save_with_val(state, 0.5)
    assert (tmp_path / "best.ckpt").exists() and (tmp_path / "last.ckpt").exists()
    best_mtime = (tmp_path / "best.ckpt").stat().st_mtime_ns
    # a resumed run reads best_val and keeps the better `best`
    again = tckpt.CheckpointManager(str(tmp_path), "copenet_singleview")
    assert again.best_val == 0.5
    state.step = 3
    again.save_with_val(state, 0.7)
    assert (tmp_path / "best.ckpt").stat().st_mtime_ns == best_mtime
    assert torch.load(tmp_path / "last.ckpt", weights_only=True)["global_step"] == 3
    again.save_with_val(state, 0.3)
    assert tckpt.CheckpointManager(str(tmp_path), "copenet_singleview").best_val == 0.3
    assert torch.load(tmp_path / "best.ckpt", weights_only=True)["global_step"] == 3
    # another family's state, or another optimizer's, is refused
    other, _ = create_train_state(MODEL_REGISTRY["copenet_singleview"](seed=1), 5e-5,
                                  train_reg_only=True)
    with pytest.raises(ValueError, match="another model or optimizer"):
        tckpt.CheckpointManager(str(tmp_path), "copenet_singleview").restore(other)
    with pytest.raises(ValueError, match="unknown model family"):
        tckpt.CheckpointManager(str(tmp_path), "spin")


@pytest.mark.parametrize("family", FAMILIES)
def test_port_checkpoint_loads_in_jax(family, tmp_path):
    model = perturbed_model(family, FAMILIES.index(family))
    state, _ = create_train_state(model, 5e-5)
    tckpt.CheckpointManager(str(tmp_path), family).save(state, "last")
    _, variables = jckpt.load_model_variables(family, torch_ckpt=str(tmp_path / "last.ckpt"))
    assert_forwards_agree(model, variables, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_export_loads_in_port(family, tmp_path):
    src = perturbed_model(family, 10 + FAMILIES.index(family))
    variables = jckpt.convert_reference_checkpoint(
        tckpt.reference_state_dict(src.state_dict(), family), family)
    path = jckpt.export_reference_checkpoint(variables, family, str(tmp_path / "m.ckpt"))
    model, got = tckpt.load_model_variables(family, torch_ckpt=path, device="cpu")
    assert set(got) == {"params", "batch_stats"}
    assert got["params"] == dict(model.named_parameters())
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert_forwards_agree(model, variables, family)


def test_load_model_variables_sources(tmp_path):
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        tckpt.load_model_variables("hmr", ckpt=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tckpt.load_model_variables("hmr", device="cpu")
    model, variables = tckpt.load_model_variables("hmr", random_init=True, device="cpu")
    ref = MODEL_REGISTRY["hmr"](seed=0)
    assert all(torch.equal(v, ref.state_dict()[k]) for k, v in model.state_dict().items())
    assert set(variables["batch_stats"]) == {
        k for k in ref.state_dict()
        if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tckpt.load_model_variables("hmr", random_init=True)


@pytest.mark.parametrize("family", ["copenet_twoview", "copenet_twoview_sep"])
def test_imagenet_warm_start_matches_jax(family, tmp_path):
    """A torchvision ResNet-50 file (classifier head included, keys under
    DataParallel's ``module.``) warm-starts the trunk(s) exactly as JAX's
    load_imagenet_resnet50 + warm_start_trunks do."""
    trunk = ResNet50(generator=torch.Generator().manual_seed(3))
    sd = dict(trunk.state_dict())
    sd["fc.weight"] = torch.randn(1000, 2048)
    sd["fc.bias"] = torch.randn(1000)
    path = str(tmp_path / "resnet50-imagenet.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)

    model = perturbed_model(family, 5)
    jvars = jckpt.convert_reference_checkpoint(
        tckpt.reference_state_dict(model.state_dict(), family), family)
    p, bs = jckpt.warm_start_trunks(dict(jvars["params"]), dict(jvars["batch_stats"]),
                                    jckpt.load_imagenet_resnet50(path), family)
    want = tckpt.state_dict_from_flax({"params": p, "batch_stats": bs}, family)

    variables = model_variables(model)
    tckpt.warm_start_trunks(variables["params"], variables["batch_stats"],
                            tckpt.load_imagenet_resnet50(path), family)
    got = tckpt.reference_state_dict(model.state_dict(), family)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    prefix = "trunk0." if family == "copenet_twoview_sep" else "trunk."
    assert torch.equal(model.state_dict()[prefix + "conv1.weight"], sd["conv1.weight"])

    with pytest.raises(ValueError, match="does not match"):
        tckpt.warm_start_trunks(variables["params"], variables["batch_stats"],
                                {k: v for k, v in sd.items() if "layer4" not in k}, family)
