"""Port parity of the real-data self-supervised path (airpose_tpu_torch vs
airpose_tpu on the same numpy inputs and weights, on the CPU, f32): the two
real losses, their gradients (through rotmat_to_aa and VPoser), one whole
real step of each kind, and the DJI and AirCap readers.

The VPoser latent sample's noise cannot match across frameworks (as dropout
cannot), so each test fixes it on both sides: each package's
``vposer_rsample``, as its losses module sees it, is replaced by
``mu + sigma · eps`` with one numpy ``eps``.

Tolerances, each with its reason:
  - every loss term within rtol 1e-5 of JAX's, the bound of
    tests/test_torch_losses.py (the same f32 arithmetic through SMPL-X);
  - the losses' gradients with respect to the predictions within rtol 1e-4
    of each gradient's largest entry, the bound of tests/test_torch_train.py
    for gradients through SMPL-X (f32 sums in other orders);
  - the whole steps (marked slow: 22-26 s each alone, 13-14 s of it XLA
    compiling JAX's ResNet-50 train step) at tests/test_torch_train.py's
    whole-step bounds, set by
    flax's own f32 train-mode BatchNorm error (f32 trunk at 64 px, dropout
    off on both sides): eval_step's outputs atol 1e-4 and loss rtol 1e-4
    before the step; after it each loss term rtol 2e-3, each running
    statistic rel-L2 2e-3, and the parameter update equal (rtol 1e-3) on
    ≥ 99.9% of the entries whose gradient is above 0.1 of its tensor's
    largest;
  - the readers' arrays and host batches equal to JAX's, entry for entry,
    but the ArUco extrinsics' rotations: the port's batch_rodrigues and
    XLA's round f32 sin/cos/sqrt differently, so they are held to one f32
    ulp at 1 (atol 1.2e-7; measured 3.7e-9 on 5 of 128 entries).
"""

import json
import os
import pickle
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import _write_fake_aircap, _write_fake_real  # noqa: E402
from test_torch_families import reference_sd  # noqa: E402
from test_torch_train import B as STEP_B  # noqa: E402
from test_torch_train import data, no_dropout, smplx_pair  # noqa: E402,F401  (fixtures)
from test_torch_train import _rel_close  # noqa: E402
from test_torch_train_families import RecordingAMSGrad, _port_state  # noqa: E402

import airpose_tpu.train.losses as JL  # noqa: E402
from airpose_tpu.bodymodel.vposer import init_vposer_params as j_init_vposer  # noqa: E402
from airpose_tpu.config import RealLossWeights as JRealLossWeights  # noqa: E402
from airpose_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from airpose_tpu.data import aircap as jaircap  # noqa: E402
from airpose_tpu.data import real as jreal  # noqa: E402
from airpose_tpu.geometry.rotations import rot6d_to_rotmat as j_rot6d  # noqa: E402
from airpose_tpu.geometry.rotations import rotmat_to_aa as j_rotmat_to_aa  # noqa: E402
from airpose_tpu.models import MODEL_REGISTRY as JREGISTRY  # noqa: E402
from airpose_tpu.train.checkpoint import convert_reference_checkpoint  # noqa: E402
from airpose_tpu.train.loop import make_real_singleview_step_fns as j_real_singleview  # noqa: E402
from airpose_tpu.train.loop import make_real_twoview_step_fns as j_real_twoview  # noqa: E402
from airpose_tpu.train.state import TrainState as JTrainState  # noqa: E402
from airpose_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
import airpose_tpu_torch.train.losses as TL  # noqa: E402
from airpose_tpu_torch import constants as C  # noqa: E402
from airpose_tpu_torch.bodymodel import vposer_params_from_numpy  # noqa: E402
from airpose_tpu_torch.config import RealLossWeights, TrainConfig  # noqa: E402
from airpose_tpu_torch.data import aircap as taircap  # noqa: E402
from airpose_tpu_torch.data import real as treal  # noqa: E402
from airpose_tpu_torch.data.fake_real import write_fake_real_capture  # noqa: E402
from airpose_tpu_torch.data.validate import DbSchemaError  # noqa: E402
from airpose_tpu_torch.geometry import rot6d_to_rotmat, rotmat_to_aa  # noqa: E402
from airpose_tpu_torch.models import MODEL_REGISTRY  # noqa: E402
from airpose_tpu_torch.train import (create_train_state, make_real_singleview_step_fns,  # noqa: E402
                                     make_real_twoview_step_fns)

B = 3
EPS = np.random.default_rng(11).normal(size=(2 * max(B, STEP_B), 32)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (six pytest workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixed_noise(monkeypatch):
    monkeypatch.setattr(JL, "vposer_rsample",
                        lambda mu, sigma, key: mu + sigma * jnp.asarray(EPS[:mu.shape[0]]))
    monkeypatch.setattr(TL, "vposer_rsample",
                        lambda mu, sigma, generator: mu + sigma * torch.from_numpy(
                            EPS[:mu.shape[0]]))


@pytest.fixture(scope="module")
def vposer_pair():
    jparams = j_init_vposer(0)
    return jparams, vposer_params_from_numpy(jparams)


def _real_batch(rng, n, images=None):
    """A real-data batch: per-view intrinsics at the DJI focal lengths,
    confidence-weighted full-frame 2D keypoints near the body's projection
    and crop-frame ones, no 3D ground truth."""
    intr = np.tile(np.asarray([[1537.0, 0, 1018.0], [0, 1517.0, 577.0], [0, 0, 1]],
                              np.float32), (n, 2, 1, 1))
    uv = np.stack([rng.uniform(850, 1150, (n, 2, 22)), rng.uniform(400, 750, (n, 2, 22))], -1)
    crop = rng.normal(size=(n, 2, 24, 2)) * 60.0
    batch = {
        "intr": intr,
        "gt_j2d_conf": np.concatenate([uv, rng.uniform(0, 1, (n, 2, 22, 1))], -1),
        "gt_j2d_crop_conf": np.concatenate([crop, rng.uniform(0, 1, (n, 2, 24, 1))], -1),
        "focal": np.asarray([C.REAL_FOCAL_LENGTH0, C.REAL_FOCAL_LENGTH1]),
    }
    if images is not None:
        batch["images"], batch["bb"] = images
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def _preds(rng, lead):
    pose = rng.normal(size=lead + (135,)).astype(np.float32) * 0.3
    pose[..., :3] = rng.normal(size=lead + (3,)) * 0.02 + np.asarray([0.0, 0.0, 0.45])
    betas = rng.normal(size=lead + (10,)).astype(np.float32) * 0.5
    cam = np.abs(rng.normal(size=lead + (3,))).astype(np.float32) * 0.3 + 0.5
    return pose, betas, cam


def _compare(got, want, grads, jgrads, names):
    (tot, met), (jtot, jmet) = got, want
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k].detach().numpy(), np.asarray(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tot.item(), float(jtot), rtol=1e-5)
    for name, g, jg in zip(names, grads, jgrads):
        _rel_close(g.numpy(), np.asarray(jg), 1e-4, name)


def test_real_twoview_loss_and_gradients_match_jax(smplx_pair, vposer_pair, fixed_noise):
    rng = np.random.default_rng(0)
    (jsmplx, tsmplx), (jvp, tvp) = smplx_pair, vposer_pair
    pose, betas, _ = _preds(rng, (B, 2))
    batch = _real_batch(rng, B)
    w, jw = RealLossWeights(), JRealLossWeights()

    def jloss(p, b):
        return JL.real_twoview_loss(p, b, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jsmplx, jvp, jw, jax.random.PRNGKey(0))

    want, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(pose), jnp.asarray(betas))
    tp, tb = (torch.from_numpy(a).requires_grad_(True) for a in (pose, betas))
    got = TL.real_twoview_loss(tp, tb, {k: torch.from_numpy(v) for k, v in batch.items()},
                               tsmplx, tvp, w, None)
    grads = torch.autograd.grad(got[0], (tp, tb))
    _compare(got, want, grads, jgrads, ("pose", "betas"))
    # the 2D term sums the two views before the mean (mean(view 0) + mean(view 1))
    assert got[1]["loss_keypoints"].item() > 0


@pytest.mark.parametrize("view", [0, 1])
def test_real_singleview_loss_and_gradients_match_jax(smplx_pair, vposer_pair, fixed_noise,
                                                      view):
    rng = np.random.default_rng(1 + view)
    (jsmplx, tsmplx), (jvp, tvp) = smplx_pair, vposer_pair
    pose, betas, cam = _preds(rng, (B,))
    pose6d = pose[:, 3:]
    batch = _real_batch(rng, B)
    w, jw = RealLossWeights(), JRealLossWeights()

    def jloss(p, b, c):
        return JL.real_singleview_loss(p, b, c, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jsmplx, jvp, jw, jax.random.PRNGKey(0), view=view)

    args = [jnp.asarray(a) for a in (pose6d, betas, cam)]
    want, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(*args)
    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
             for a in (pose6d, betas, cam)]
    got = TL.real_singleview_loss(*targs, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  tsmplx, tvp, w, None, view=view)
    grads = torch.autograd.grad(got[0], targs)
    _compare(got, want, grads, jgrads, ("pose6d", "betas", "cam"))


def test_rotmat_to_aa_gradient_matches_jax():
    """The VPoser term differentiates through rot6d → rotmat → axis-angle:
    values at rtol 1e-5, the gradient within 1e-4 of its largest entry."""
    rng = np.random.default_rng(4)
    six = rng.normal(size=(64, 6)).astype(np.float32)
    wts = rng.normal(size=(64, 3)).astype(np.float32)

    def jfn(x):
        return (j_rotmat_to_aa(j_rot6d(x)) * wts).sum()

    t = torch.from_numpy(six).requires_grad_(True)
    aa = rotmat_to_aa(rot6d_to_rotmat(t))
    (g,) = torch.autograd.grad((aa * torch.from_numpy(wts)).sum(), t)
    np.testing.assert_allclose(aa.detach().numpy(), np.asarray(j_rotmat_to_aa(j_rot6d(six))),
                               rtol=1e-5, atol=1e-6)
    _rel_close(g.numpy(), np.asarray(jax.jit(jax.grad(jfn))(jnp.asarray(six))), 1e-4, "d six")


@pytest.mark.parametrize("kind", ["twoview", "singleview"])
def test_real_losses_honour_row_weight(smplx_pair, vposer_pair, fixed_noise, kind):
    """A padded eval batch (B rows, the last one garbage with row weight 0):
    every term and gradient at the bounds above against JAX's on the same
    padded batch, and every term equal (rtol 1e-6) to the port's loss on the
    B − 1 valid rows alone (the fixed noise's rows do not depend on B)."""
    rng = np.random.default_rng(7)
    (jsmplx, tsmplx), (jvp, tvp) = smplx_pair, vposer_pair
    pose, betas, cam = _preds(rng, (B, 2) if kind == "twoview" else (B,))
    batch = _real_batch(rng, B)
    batch["gt_j2d_conf"][-1] = 1e6
    batch["gt_j2d_crop_conf"][-1] = 1e6
    batch["row_weight"] = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    preds = (pose, betas) if kind == "twoview" else (pose[:, 3:], betas, cam)
    names = ("pose", "betas") if kind == "twoview" else ("pose6d", "betas", "cam")

    def jloss(b, *p):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if kind == "twoview":
            return JL.real_twoview_loss(*p, b, jsmplx, jvp, JRealLossWeights(),
                                        jax.random.PRNGKey(0))
        return JL.real_singleview_loss(*p, b, jsmplx, jvp, JRealLossWeights(),
                                       jax.random.PRNGKey(0), view=1)

    def tloss(b, *p):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if kind == "twoview":
            return TL.real_twoview_loss(*p, b, tsmplx, tvp, RealLossWeights(), None)
        return TL.real_singleview_loss(*p, b, tsmplx, tvp, RealLossWeights(), None, view=1)

    want, jgrads = jax.jit(jax.value_and_grad(partial(jloss, batch),
                                              argnums=tuple(range(len(preds))), has_aux=True))(
        *[jnp.asarray(a) for a in preds])
    targs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in preds]
    got = tloss(batch, *targs)
    _compare(got, want, torch.autograd.grad(got[0], targs), jgrads, names)

    valid = {k: v[:B - 1] for k, v in batch.items() if k not in ("focal", "row_weight")}
    valid["focal"] = batch["focal"]
    _, unpadded = tloss(valid, *[torch.from_numpy(np.ascontiguousarray(a[:B - 1]))
                                 for a in preds])
    for k, v in unpadded.items():
        np.testing.assert_allclose(got[1][k].item(), v.item(), rtol=1e-6, err_msg=k)


# ---- whole steps ----------------------------------------------------------------

def _check_step(family, model, state, tx, before, metrics, jmetrics, jstate):
    """After one step on both packages: the loss terms, the running
    statistics and the parameter update (the whole-step bounds above)."""
    assert state.step == 1 and int(jstate.step) == 1
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-3, err_msg=k)
    after = _port_state(family, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    jtensors = dict(after.named_parameters()) | dict(after.named_buffers())
    n_stats = shown = same = 0
    for name, got_t in state.batch_stats.items():
        if "num_batches" not in name:
            want_t = jtensors[name]
            assert ((got_t - want_t).norm() / want_t.norm()).item() <= 2e-3, name
            n_stats += 1
    for name, p in state.params.items():
        g = tx.grads[name].abs()
        mask = g > 0.1 * g.max()
        d_port = (p - before[name])[mask]
        d_jax = (jtensors[name].detach() - before[name])[mask]
        shown += int(mask.sum())
        same += int(((d_port - d_jax).abs() <= 1e-3 * d_jax.abs()).sum())
    assert n_stats == 106 and shown > 1_000_000
    assert same >= 0.999 * shown, (same, shown)


def _setup(family, data):  # noqa: F811
    model = MODEL_REGISTRY[family](seed=4)
    variables = jax.tree.map(np.array, convert_reference_checkpoint(reference_sd(model, family),
                                                                    family))
    cfg, jcfg = TrainConfig(batch_size=STEP_B, model=family), JTrainConfig(batch_size=STEP_B,
                                                                         model=family)
    state, _ = create_train_state(model, cfg.lr)
    tx = RecordingAMSGrad(cfg.lr)
    jtx = j_make_optimizer(jcfg.lr)
    jstate = JTrainState(step=0, params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=jtx.init(variables["params"]))
    batch = _real_batch(np.random.default_rng(9), STEP_B, (data["images"], data["bb"]))
    return model, cfg, jcfg, state, tx, jtx, jstate, batch


@pytest.mark.slow
def test_real_twoview_step_matches_jax(smplx_pair, data, no_dropout, vposer_pair,  # noqa: F811
                                       fixed_noise):
    family = "copenet_twoview"
    (jsmplx, tsmplx), (jvp, tvp) = smplx_pair, vposer_pair
    model, cfg, jcfg, state, tx, jtx, jstate, batch = _setup(family, data)
    train_step, eval_step = make_real_twoview_step_fns(model, tsmplx, tvp, cfg, tx, device="cpu")
    j_train, j_eval = j_real_twoview(JREGISTRY[family](), jsmplx, jvp, jcfg, jtx)
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jm, jp = j_eval(jstate, jbatch)
    tm, tp = eval_step(state, tbatch)
    for k, w in zip(jp._fields, jp):
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(w), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)

    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = train_step(state, tbatch, torch.Generator().manual_seed(0))
    jstate, jmetrics = j_train(jstate, jbatch, jax.random.PRNGKey(0))
    _check_step(family, model, state, tx, before, metrics, jmetrics, jstate)


@pytest.mark.slow
@pytest.mark.parametrize("family,view", [("hmr_camswap_difffl", 1), ("spin", 0)])
def test_real_singleview_step_matches_jax(smplx_pair, data, no_dropout,  # noqa: F811
                                          vposer_pair, fixed_noise, family, view):
    (jsmplx, tsmplx), (jvp, tvp) = smplx_pair, vposer_pair
    model, cfg, jcfg, state, tx, jtx, jstate, batch = _setup("hmr", data)
    train_step, eval_step = make_real_singleview_step_fns(model, tsmplx, tvp, cfg, tx, family,
                                                          device="cpu")
    j_train, j_eval = j_real_singleview(JREGISTRY["hmr"](), jsmplx, jvp, jcfg, jtx, family)
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jm, jp = j_eval(jstate, jbatch)
    tm, tp = eval_step(state, tbatch)
    for k, w in zip(jp._fields, jp):
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(w), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)

    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = train_step(state, tbatch, torch.Generator().manual_seed(0), view)
    jstate, jmetrics = j_train(jstate, jbatch, jax.random.PRNGKey(0), view)
    _check_step("hmr", model, state, tx, before, metrics, jmetrics, jstate)


def test_real_step_factories_refuse_unknown_families(smplx_pair, vposer_pair):
    model = MODEL_REGISTRY["hmr"](seed=0)
    with pytest.raises(ValueError, match="not a real single-view family"):
        make_real_singleview_step_fns(model, smplx_pair[1], vposer_pair[1], TrainConfig(),
                                      None, "muhmr", device="cpu")


# ---- readers --------------------------------------------------------------------

def _assert_equal(got, want, what):
    if what == "extr":  # ArUco rotations: one f32 ulp at 1 (module docstring)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_same_arrays(got, want, names):
    for k in names:
        _assert_equal(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)), k)


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        _assert_equal(got[k], want[k], k)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_copenet_real_reader_matches_jax(tmp_path, scale):
    root = str(tmp_path)
    _write_fake_real(root, n=6, scale=scale)
    for kw in ({"frame_range": range(0, 4)},
               {"frame_range": range(1, 6), "shuffle_cams": True, "context_size": 336},
               {"frame_range": range(0, 6), "first_cam": 1}):
        got, want = treal.CopenetRealDataset(root, **kw), jreal.CopenetRealDataset(root, **kw)
        assert got.frame_wh == want.frame_wh == (int(1920 * scale), int(1080 * scale))
        assert len(got) == len(want) and got.focal_pairs() == want.focal_pairs()
        _assert_same_arrays(got, want, ("opose", "apose", "intr", "extr"))
        for key in ("openpose", "alphapose"):
            np.testing.assert_array_equal(got.keypoints(2)[key], want.keypoints(2)[key])
        idx = [0, 3, 1, 2]
        _assert_same_batch(got.host_batch(idx, np.random.default_rng(5)),
                           want.host_batch(idx, np.random.default_rng(5)))
        _assert_same_batch(got.host_batch(idx, np.random.default_rng(5), decode_images=False),
                           want.host_batch(idx, np.random.default_rng(5), decode_images=False))
    assert treal.person_crop_box(got.opose[0, 1], got.frame_wh) == jreal.person_crop_box(
        want.opose[0, 1], want.frame_wh)


def test_fake_capture_writer_matches_the_fixture_writer(tmp_path):
    """The port's writer (chip_smoke.py's capture) writes what
    tests/test_data.py's fixture writer does, file for file."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_fake_real(a, n=3, scale=0.5)
    write_fake_real_capture(b, n=3, scale=0.5)
    for m in (1, 2):
        for name in ("openpose_res.pkl", "markerposes_corrected_all.pkl"):
            with open(os.path.join(a, f"machine_{m}", name), "rb") as fa, \
                    open(os.path.join(b, f"machine_{m}", name), "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            assert sorted(pa) == sorted(pb)
            for key in pa:
                flat_a = pa[key]["pose"] if "pose" in pa[key] else pa[key]["0"]["rvec"]
                flat_b = pb[key]["pose"] if "pose" in pb[key] else pb[key]["0"]["rvec"]
                np.testing.assert_array_equal(flat_a, flat_b)
        for name in ("alphapose_res.json", "camera_calib.yml"):
            with open(os.path.join(a, f"machine_{m}", name)) as fa, \
                    open(os.path.join(b, f"machine_{m}", name)) as fb:
                assert fa.read() == fb.read(), name
        for i in range(3):
            path = os.path.join(f"machine_{m}", "images", f"{i:06d}.jpg")
            with open(os.path.join(a, path), "rb") as fa, open(os.path.join(b, path), "rb") as fb:
                assert fa.read() == fb.read(), path


def test_aircap_reader_matches_jax(tmp_path):
    root = str(tmp_path)
    _write_fake_aircap(root, n=6, drop_person_at=(2,))
    for kw in ({}, {"drange": range(1, 4), "first_cam": 1}):
        got, want = taircap.AircapDataset(root, **kw), jaircap.AircapDataset(root, **kw)
        assert got.pairs == want.pairs and got.image_paths == want.image_paths
        assert got.frame_wh == want.frame_wh and got.focal_pairs() == want.focal_pairs()
        _assert_same_arrays(got, want, ("opose", "apose", "intr", "extr"))
        idx = list(range(len(got)))[::-1]
        _assert_same_batch(got.host_batch(idx, np.random.default_rng(2)),
                           want.host_batch(idx, np.random.default_rng(2)))
    assert len(taircap.AircapDataset(root)) == 5  # frame 2 dropped: machine 1 saw nobody
    assert taircap._closest(np.asarray([1.0, 2.0, 3.0]), 2.2) == 1


def test_layout_errors_are_db_schema_errors(tmp_path):
    """Each missing piece is one DbSchemaError whose message is JAX's."""
    root = str(tmp_path / "cap")
    os.makedirs(os.path.join(root, "machine_1"))
    with open(os.path.join(root, "machine_1", "openpose_res.pkl"), "wb") as f:
        pickle.dump({}, f)
    cases = [(treal.validate_capture_layout, jreal.validate_capture_layout, root),
             (treal.validate_capture_layout, jreal.validate_capture_layout,
              str(tmp_path / "none")),
             (taircap.validate_aircap_layout, jaircap.validate_aircap_layout, root),
             (taircap.validate_aircap_layout, jaircap.validate_aircap_layout,
              str(tmp_path / "none"))]
    for ours, theirs, path in cases:
        with pytest.raises(DbSchemaError) as got:
            ours(path)
        with pytest.raises(Exception) as want:
            theirs(path)
        assert str(got.value) == str(want.value)
    with pytest.raises(DbSchemaError, match="missing"):
        treal.CopenetRealDataset(root)
    with pytest.raises(DbSchemaError, match="tstamps.npz"):
        taircap.AircapDataset(root)
    assert json.dumps(treal.MACHINE_FILES) == json.dumps(jreal.MACHINE_FILES)
    np.testing.assert_array_equal(treal.OP_MAP2SMPL, jreal.OP_MAP2SMPL)
    np.testing.assert_array_equal(treal.AL_MAP2SMPL, jreal.AL_MAP2SMPL)
