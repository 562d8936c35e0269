"""Port parity of the eval CLI (airpose_tpu_torch.eval.compile_results vs
airpose_tpu.eval.compile_results, on the CPU): the compile passes on the
same numpy batches and weights, the cross-view metric and the --save-full
body fields, the tail batch's masked loss, the outputs pkl read by either
package's outputs_to_ba_init, and the CLI on every data source.

Weights start from a seeded port model with BatchNorm statistics moved off
(0, 1) and reach flax through the reference state dict; both packages run
the f32 trunk, as both CLIs build it (the model classes' default dtype), at
64 px, B = 3 over 7 frames, so the tail batch is padded. The real loss's
VPoser noise cannot match across frameworks, so the real pass fixes it on
both sides as tests/test_torch_real.py does.

Tolerances, each with its reason:
  - the compile passes' outputs atol = rtol = 1e-4 and their metrics rtol
    1e-4: tests/test_torch_families.py's bounds for the same f32 trunk and
    IEF;
  - the cross-view metric and the body fields atol 1e-5: f32 SMPL-X sums in
    other orders (tests/test_torch_eval.py measured 2.5e-7 relative);
  - the masked tail loss rtol 1e-5, JAX's tests/test_compile_results.py
    bound;
  - the two packages' CLIs (marked slow: the JAX CLI initialises a flax
    ResNet-50 and compiles its eval step, ~60 s the first time) on one
    --torch_ckpt written by JAX's export_reference_checkpoint, at
    tests/test_torch_perception.py's chain bounds (rel-L2 0.1 on the 3D
    outputs, 0.02 on the 2D ones): each CLI crops its images through its
    own finish_batch (1e-5 apart, tests/test_torch_data.py); their metrics
    within 10%, the real losses' VPoser samples being each package's own;
  - --int8 at tests/test_torch_int8.py's chain bounds (pose MAD below 0.15
    of its RMS, rel-L2 0.02): each package calibrates its own activation
    scales.
"""

import json
import os
import pickle
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import (_write_fake_aerialpeople, _write_fake_aircap,  # noqa: E402
                       _write_fake_h36m, _write_fake_real, _write_fake_totalcap)
from test_torch_checkpoint import perturbed_model  # noqa: E402
from test_torch_families import reference_sd  # noqa: E402

import airpose_tpu.train.losses as JL  # noqa: E402
from airpose_tpu.bodymodel import init_vposer_params as j_init_vposer  # noqa: E402
from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic  # noqa: E402
from airpose_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from airpose_tpu.data import CopenetRealDataset as JRealDataset  # noqa: E402
from airpose_tpu.eval import compile_results as jcr  # noqa: E402
from airpose_tpu.models import MODEL_REGISTRY as JREGISTRY  # noqa: E402
from airpose_tpu.train.checkpoint import (convert_reference_checkpoint,  # noqa: E402
                                         export_reference_checkpoint)
from airpose_tpu.train.state import TrainState as JTrainState  # noqa: E402
import airpose_tpu_torch.train.losses as TL  # noqa: E402
from airpose_tpu_torch.bodymodel import synthetic_smplx_params  # noqa: E402
from airpose_tpu_torch.bodymodel import vposer_params_from_numpy  # noqa: E402
from airpose_tpu_torch.config import RealLossWeights, TrainConfig  # noqa: E402
from airpose_tpu_torch.data import CopenetRealDataset, make_synthetic_dataset  # noqa: E402
from airpose_tpu_torch.eval import compile_results as tcr  # noqa: E402
from airpose_tpu_torch.train import TrainState, real_twoview_loss  # noqa: E402
from airpose_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from airpose_tpu_torch.train.state import create_train_state, model_variables  # noqa: E402

B, N, IMG, V = 3, 7, 64, 99
EPS = np.random.default_rng(11).normal(size=(2 * B, 32)).astype(np.float32)


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
    """Two intra-op threads while this module runs (six pytest workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smplx_pair():
    return jsynthetic(num_vertices=V, seed=4), synthetic_smplx_params(num_vertices=V, seed=4)


@pytest.fixture(scope="module")
def vposer_pair():
    jparams = j_init_vposer(0)
    return jparams, vposer_params_from_numpy(jparams)


@pytest.fixture
def fixed_noise(monkeypatch):
    monkeypatch.setattr(JL, "vposer_rsample",
                        lambda mu, sigma, key: mu + sigma * jnp.asarray(EPS[:mu.shape[0]]))
    monkeypatch.setattr(TL, "vposer_rsample", lambda mu, sigma, generator: mu + sigma * (
        torch.from_numpy(EPS[:mu.shape[0]])))


def _states(family, seed=0):
    """(port model, its TrainState, JAX TrainState) on one set of weights."""
    model = perturbed_model(family, seed)
    variables = convert_reference_checkpoint(reference_sd(model, family), family)
    jstate = JTrainState(step=0, params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None)
    return model, TrainState(step=0, **model_variables(model), opt_state=None), jstate


@pytest.fixture(scope="module")
def synthetic_data(smplx_pair):
    """N frames of the synthetic dataset at 64 px, as numpy."""
    data = make_synthetic_dataset(smplx_pair[1], N, seed=5, img_size=IMG, blob_sigma=3.0)
    return {k: v.numpy() for k, v in data.items()}


def _port_batches(data):
    return tcr.synthetic_batches({k: torch.from_numpy(v.copy()) for k, v in data.items()}, B)


def _assert_outputs_close(got, want, atol=1e-4, rtol=1e-4):
    """Two outputs lists batch for batch: keys, dtypes and shapes equal,
    values within the bounds."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g["output"], w["output"]
        assert sorted(g) == sorted(w)
        for k in w:
            wk = np.asarray(w[k])
            assert g[k].dtype == wk.dtype and g[k].shape == wk.shape, k
            np.testing.assert_allclose(g[k], wk, atol=atol, rtol=rtol, err_msg=k)


def _assert_metrics_close(got, want, rtol=1e-4):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def twoview_runs(smplx_pair, synthetic_data):
    """compile_twoview on both packages: (port outputs, port metrics, JAX
    outputs, JAX metrics)."""
    model, state, jstate = _states("copenet_twoview")
    got = tcr.compile_twoview(state, model, smplx_pair[1], _port_batches(synthetic_data),
                              TrainConfig(img_res=IMG), device="cpu")
    want = jcr.compile_twoview(jstate, JREGISTRY["copenet_twoview"](), smplx_pair[0],
                               jcr.synthetic_batches(synthetic_data, B),
                               JTrainConfig(img_res=IMG))
    return got + want


def test_compile_twoview_matches_jax(twoview_runs):
    outputs, metrics, joutputs, jmetrics = twoview_runs
    assert [len(o["output"]["pred_angles0"]) for o in outputs] == [3, 3, 1]  # the tail cut
    _assert_outputs_close(outputs, joutputs)
    _assert_metrics_close(metrics, jmetrics)


def test_outputs_pkl_reads_in_either_package(twoview_runs, vposer_pair, tmp_path):
    """Each package's pkl, through a pickle file, into both packages'
    outputs_to_ba_init: the two inits equal."""
    jvp, tvp = vposer_pair
    for outputs in (twoview_runs[0], twoview_runs[2]):
        path = tmp_path / "outputs.pkl"
        with open(path, "wb") as f:
            pickle.dump([outputs], f)
        with open(path, "rb") as f:
            split = pickle.load(f)[0]
        got, want = tcr.outputs_to_ba_init(split, tvp), jcr.outputs_to_ba_init(split, jvp)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_compile_singleview_matches_jax(smplx_pair, synthetic_data):
    model, state, jstate = _states("hmr", seed=1)
    cfg, jcfg = TrainConfig(model="hmr", img_res=IMG), JTrainConfig(model="hmr", img_res=IMG)
    outputs, metrics = tcr.compile_singleview(state, model, smplx_pair[1],
                                              _port_batches(synthetic_data), cfg, "hmr",
                                              device="cpu")
    joutputs, jmetrics = jcr.compile_singleview(jstate, JREGISTRY["hmr"](), smplx_pair[0],
                                                jcr.synthetic_batches(synthetic_data, B), jcfg,
                                                "hmr")
    assert sum(len(o["output"]["pred_angles"]) for o in outputs) == N
    _assert_outputs_close(outputs, joutputs)
    _assert_metrics_close(metrics, jmetrics)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capture"))
    _write_fake_real(root, n=N)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_real_batches_match_jax(capture):
    """The tail-padded real eval batches (focal pair swapped with
    first_cam=1, row weights) against JAX's, at finish_batch's image bound."""
    for first_cam in (0, 1):
        got = list(tcr.real_batches(CopenetRealDataset(capture, range(0, N), first_cam), B, IMG,
                                    "cpu"))
        want = list(jcr.real_batches(JRealDataset(capture, range(0, N), first_cam), B, IMG))
        assert [b["_valid"] for b in got] == [b["_valid"] for b in want] == [3, 3, 1]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                if k != "_valid":
                    np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                               atol=1e-5 if k == "images" else 1e-6,
                                               rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got[-1]["row_weight"].numpy(), [1, 0, 0])
        assert got[0]["focal"][0, 0].item() == (1537.0 if first_cam == 0 else 1361.0)


def test_compile_real_twoview_matches_jax(smplx_pair, vposer_pair, capture, fixed_noise,
                                          monkeypatch):
    """On the same numpy batches (the port's real_batches, held to JAX's
    above): outputs with --save-full, the per-frame loss over the tail and
    the cross-view metric."""
    model, state, jstate = _states("copenet_twoview", seed=2)
    batches = [{k: v if k == "_valid" else v.numpy() for k, v in b.items()}
               for b in tcr.real_batches(CopenetRealDataset(capture, range(0, N)), B, IMG, "cpu")]
    monkeypatch.setattr(tcr, "real_batches", lambda *a, **k: (
        {k_: v if k_ == "_valid" else torch.from_numpy(v.copy()) for k_, v in b.items()}
        for b in batches))
    monkeypatch.setattr(jcr, "real_batches", lambda *a, **k: (
        {k_: v if k_ == "_valid" else jnp.asarray(v) for k_, v in b.items()} for b in batches))
    outputs, metrics = tcr.compile_real_twoview(
        state, model, smplx_pair[1], vposer_pair[1], CopenetRealDataset(capture, range(0, N)), B,
        TrainConfig(img_res=IMG), save_full=True, out_size=IMG, device="cpu")
    joutputs, jmetrics = jcr.compile_real_twoview(
        jstate, JREGISTRY["copenet_twoview"](), smplx_pair[0], vposer_pair[0],
        JRealDataset(capture, range(0, N)), B, JTrainConfig(img_res=IMG), save_full=True,
        out_size=IMG)
    assert sum(len(o["output"]["pred_pose0"]) for o in outputs) == N
    _assert_outputs_close(outputs, joutputs)
    _assert_metrics_close(metrics, jmetrics)
    assert metrics["robust_frames"] == N


def _random_predictions(rng, n):
    from scipy.spatial.transform import Rotation

    aa = rng.normal(size=(n * 2 * 22, 3)) * 0.4
    rotmat = Rotation.from_rotvec(aa).as_matrix().reshape(n, 2, 22, 3, 3).astype(np.float32)
    betas = rng.normal(size=(n, 2, 10)).astype(np.float32) * 0.5
    trans = (rng.normal(size=(n, 2, 3)) * 0.3 + [0, 0, 8]).astype(np.float32)
    return rotmat, betas, trans


def test_robust_crossview_consistency_matches_jax(smplx_pair, rng):
    rotmat, betas, _ = _random_predictions(rng, 5)
    from scipy.spatial.transform import Rotation

    extr = np.tile(np.eye(4, dtype=np.float32), (5, 2, 1, 1))
    extr[:, :, :3, :3] = Rotation.from_rotvec(rng.normal(size=(10, 3)) * 0.3).as_matrix(
    ).reshape(5, 2, 3, 3)
    for mask in (np.ones(5, bool), np.asarray([True, False, True, False, False])):
        got = tcr.robust_crossview_consistency(smplx_pair[1], rotmat, betas, extr, mask)
        want = jcr.robust_crossview_consistency(smplx_pair[0], rotmat, betas, extr, mask)
        np.testing.assert_allclose(got, want, atol=1e-5)
    # the same body in both views, identity extrinsics: zero
    same = np.stack([rotmat[:, 0]] * 2, axis=1)
    eye = np.tile(np.eye(4, dtype=np.float32), (5, 2, 1, 1))
    assert tcr.robust_crossview_consistency(smplx_pair[1], same, np.stack(
        [betas[:, 0]] * 2, axis=1), eye, np.ones(5, bool)) < 1e-5


@pytest.mark.parametrize("focal", ["crop", "per_view"])
def test_full_body_fields_match_jax(smplx_pair, rng, focal):
    from airpose_tpu_torch import constants as C

    rotmat, betas, trans = _random_predictions(rng, 4)
    intr = np.tile(np.asarray([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]], np.float32),
                   (4, 2, 1, 1))
    f = C.FOCAL_LENGTH if focal == "crop" else np.asarray([[1537.0, 1517.0], [1361.0, 1378.0]],
                                                          np.float32)
    in_trans = np.tile([0, 0, 10.0], (4, 2, 1)).astype(np.float32)
    got = tcr._full_body_fields(smplx_pair[1], rotmat, betas, trans, intr, f, in_trans)
    want = jcr._full_body_fields(smplx_pair[0], rotmat, betas, trans, intr, f, in_trans)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 if "j2d" not in k else 1e-3,
                                   rtol=1e-5, err_msg=k)


def test_eval_tail_loss_is_exact_masked_mean(smplx_pair, vposer_pair, rng):
    """JAX's tests/test_compile_results.py:419-463 on the port: a (B = 4,
    valid = 3) padded batch whose pad row is garbage reports the loss of
    the unpadded 3-row batch (VPoser weight 0: free of the sample)."""
    w = RealLossWeights(vposer=0.0)
    kp = rng.uniform(0, 1, (4, 2, 22, 3)).astype(np.float32) * np.float32([900, 500, 1])
    intr = torch.tensor([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]]).expand(4, 2, 3, 3)
    pose = torch.from_numpy((rng.normal(0, 0.3, (4, 2, 135)) + np.concatenate(
        [np.full(3, 0.3), np.zeros(132)])).astype(np.float32))
    betas = torch.from_numpy(rng.normal(0, 1, (4, 2, 10)).astype(np.float32))
    bad = kp.copy()
    bad[3] = 1e6
    batch4 = {"gt_j2d_conf": torch.from_numpy(bad), "intr": intr,
              "row_weight": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    batch3 = {"gt_j2d_conf": torch.from_numpy(kp[:3]), "intr": intr[:3]}
    gen = torch.Generator().manual_seed(0)
    loss4, m4 = real_twoview_loss(pose, betas, batch4, smplx_pair[1], vposer_pair[1], w, gen)
    loss3, m3 = real_twoview_loss(pose[:3], betas[:3], batch3, smplx_pair[1], vposer_pair[1], w,
                                  gen)
    np.testing.assert_allclose(loss4.item(), loss3.item(), rtol=1e-5)
    np.testing.assert_allclose(m4["loss_keypoints"].item(), m3["loss_keypoints"].item(),
                               rtol=1e-5)


# ---- the port's CLI on every data source ----------------------------------------

def _cli(out, *args):
    return ["--out", str(out), "--img_res", str(IMG), "--synthetic_verts", str(V),
            "--platform", "cpu", *args]


def _rows(pkl, key, split=0):
    with open(pkl, "rb") as f:
        return sum(o["output"][key].shape[0] for o in pickle.load(f)[split])


@pytest.fixture(scope="module")
def aerial(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aerial"))
    _write_fake_aerialpeople(root, jsynthetic(num_vertices=V, seed=4), n=5)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_cli_aerialpeople_splits_and_save_full(aerial, tmp_path, capsys):
    """Both splits in [test, train] order, every frame (the odd split's tail
    padded, then cut), --save-full's body fields, the metrics sidecar."""
    from airpose_tpu_torch.data import AerialPeopleDataset

    out = tmp_path / "tv.pkl"
    tcr.main(_cli(out, "--model", "copenet_twoview", "--datapath", aerial, "--split", "test",
                  "train", "--batch_size", "2", "--save-full"))
    printed = capsys.readouterr().out
    assert "test_mpjpe0" in printed and "train_pa_mpjpe1" in printed
    with open(out, "rb") as f:
        res = pickle.load(f)
    assert len(res) == 2
    for i, split in enumerate(("test", "train")):
        assert _rows(out, "pred_angles0", i) == len(AerialPeopleDataset(aerial, split))
    first = res[0][0]["output"]
    assert first["pred_angles0"].shape == (2, 22, 3) and first["smplorient_rel1"].shape == (
        2, 1, 3, 3)
    assert first["pred_vertices_cam0"].shape == (2, V, 3) and first["pred_j2d_cam1"].shape == (
        2, 127, 2)
    with open(str(out) + ".metrics.json") as f:
        assert set(json.load(f)) == {"test", "train"}


def test_cli_singleview_families_and_int8(aerial, tmp_path, capsys):
    """hmr and copenet_singleview on the on-disk path; --int8 on hmr and on
    the two-view model (the clip-rate report printed, metrics finite and in
    the regime of the trunk's: tests/test_compile_results.py's gate)."""
    from airpose_tpu_torch.data import AerialPeopleDataset

    for family in ("hmr", "copenet_singleview"):
        out = tmp_path / f"{family}.pkl"
        tcr.main(_cli(out, "--model", family, "--datapath", aerial, "--batch_size", "2"))
        assert _rows(out, "pred_angles") == len(AerialPeopleDataset(aerial, "test"))
    metrics = {}
    for tag, extra in (("f32", []), ("int8", ["--int8", "--int8_calib_n", "2"])):
        out = tmp_path / f"tv_{tag}.pkl"
        tcr.main(_cli(out, "--model", "copenet_twoview", "--datapath", aerial, "--batch_size",
                      "2", *extra))
        with open(str(out) + ".metrics.json") as f:
            metrics[tag] = json.load(f)["test"]
    printed = capsys.readouterr().out
    assert "int8 calibration: 2 images; held-out clip rate" in printed
    b, q = metrics["f32"]["mpjpe0"], metrics["int8"]["mpjpe0"]
    assert np.isfinite(q) and q < 3 * b + 0.1, (b, q)


def test_cli_real_save_full_and_hmr_per_camera(capture, tmp_path, capsys):
    out = tmp_path / "real.pkl"
    tcr.main(_cli(out, "--model", "copenet_twoview", "--datapath", f"real://{capture}",
                  "--test_frames", "0", str(N), "--batch_size", str(B), "--save-full"))
    printed = capsys.readouterr().out
    assert f"test_robust_frames: {N}.0000" in printed and "test_crossview_consistency" in printed
    assert _rows(out, "pred_pose0") == N
    with open(out, "rb") as f:
        first = pickle.load(f)[0][0]["output"]
    assert first["pred_pose0"].shape == (B, 135) and first["pred_vertices_cam1"].shape == (B, V, 3)
    np.testing.assert_array_equal(first["in_smpltrans0"], np.tile([0, 0, 10.0], (B, 1)))
    out = tmp_path / "hmr_real.pkl"
    tcr.main(_cli(out, "--model", "hmr", "--datapath", f"real://{capture}", "--test_frames", "0",
                  "4", "--batch_size", "2"))
    for cam in (0, 1):
        with open(str(out) + str(cam), "rb") as f:
            o = pickle.load(f)[0][0]["output"]
        assert o["pred_angles"].shape == (2, 22, 3) and o["pred_cam"].shape == (2, 3)
        assert np.isfinite(o["pred_smpltrans"]).all()
    printed = capsys.readouterr().out
    assert "test_cam0_loss" in printed and "test_cam1_focal_x: 1361.0000" in printed
    assert not os.path.exists(out)


@pytest.mark.parametrize("source", ["aircap", "totalcap", "h36m"])
def test_cli_other_sources(source, tmp_path, capsys):
    root = str(tmp_path / source)
    os.makedirs(root)
    writer, rows, key = {"aircap": (lambda r: _write_fake_aircap(r, n=4, drop_person_at=()),
                                    4, "pred_pose0"),
                         "totalcap": (lambda r: _write_fake_totalcap(r, n=5), 1, "gt_angles0"),
                         "h36m": (lambda r: _write_fake_h36m(r, n=3), 3, "gt_joints_cam0")}[source]
    writer(root)
    out = tmp_path / "res.pkl"
    tcr.main(_cli(out, "--model", "copenet_twoview", "--datapath", f"{source}://{root}",
                  "--test_frames", "0", "4", "--batch_size", "2"))
    printed = capsys.readouterr().out
    assert _rows(out, key) == rows
    assert ("test_crossview_consistency" if source == "aircap" else "test_pa_mpjpe1") in printed


def test_cli_synthetic_checkpoints_and_refusals(tmp_path, capsys):
    """synthetic:// on its 300-vertex body; --ckpt reading a --train_reg_only
    checkpoint of the port's trainer (its optimizer state ignored); --mesh N
    with more ranks than the process group has (one here) and an orbax
    directory refused."""
    model = perturbed_model("copenet_twoview", 3)
    state, _ = create_train_state(model, 5e-5, train_reg_only=True)
    CheckpointManager(str(tmp_path / "ckpts"), "copenet_twoview").save(state, "last")
    out = tmp_path / "syn.pkl"
    tcr.main(_cli(out, "--datapath", "synthetic://5", "--batch_size", "2", "--save-full",
                  "--ckpt", str(tmp_path / "ckpts" / "last.ckpt")))
    printed = capsys.readouterr().out
    assert "loaded" in printed and "test_mpjpe0" in printed
    assert _rows(out, "pred_angles0") == 5
    with open(out, "rb") as f:
        assert pickle.load(f)[0][0]["output"]["pred_vertices_cam0"].shape == (2, 300, 3)
    for bad, msg in ((["--mesh", "2"], "the process group has 1"),
                     (["--ckpt", str(tmp_path / "ckpts")], "orbax")):
        with pytest.raises(SystemExit):
            tcr.main(_cli(out, "--datapath", "synthetic://5", *bad))
        assert msg in capsys.readouterr().err


# ---- the two packages' CLIs on one checkpoint (slow) -----------------------------

def _flat(res):
    """{key: rows of every batch of every split (or camera pkl)}."""
    keys = res[0][0]["output"].keys()
    return {k: np.concatenate([o["output"][k] for split in res for o in split]) for k in keys}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.slow
@pytest.mark.parametrize("source", ["aerialpeople", "real", "aircap", "totalcap", "h36m", "int8",
                                    "real_hmr"])
def test_cli_matches_jax_cli(source, aerial, capture, tmp_path, capsys):
    """Both CLIs on one JAX-exported --torch_ckpt and one fixture: the pkls
    key for key (dtypes and shapes equal; for hmr on real data the two
    per-camera pkls), the values within the chain bounds, the metrics within
    10% (the real losses' VPoser samples are drawn by each package's own
    generator)."""
    family = "hmr" if source == "real_hmr" else "copenet_twoview"
    model = perturbed_model(family, 4)
    variables = convert_reference_checkpoint(reference_sd(model, family), family)
    ckpt = export_reference_checkpoint(variables, family, str(tmp_path / "m.ckpt"))
    if source in ("aircap", "totalcap", "h36m"):
        root = str(tmp_path / source)
        os.makedirs(root)
        {"aircap": lambda r: _write_fake_aircap(r, n=4, drop_person_at=()),
         "totalcap": lambda r: _write_fake_totalcap(r, n=5),
         "h36m": lambda r: _write_fake_h36m(r, n=3)}[source](root)
        datapath = f"{source}://{root}"
    else:
        datapath = f"real://{capture}" if source.startswith("real") else aerial
    args = ["--model", family, "--datapath", datapath, "--torch_ckpt", ckpt,
            "--batch_size", "2", "--img_res", str(IMG), "--synthetic_verts", str(V),
            "--test_frames", "0", "4"]
    if source == "int8":
        args += ["--int8", "--int8_calib_n", "2"]
    elif source in ("aerialpeople", "real"):
        args += ["--save-full"]
    res = {}
    for tag, main, extra in (("jax", jcr.main, ["--platform", "cpu"]),
                             ("port", tcr.main, ["--platform", "cpu"])):
        out = str(tmp_path / f"{tag}.pkl")
        main(args + ["--out", out] + extra)
        res[tag] = []
        for path in ([out + "0", out + "1"] if family == "hmr" else [out]):
            with open(path, "rb") as f:
                res[tag] += pickle.load(f)
        with open(out + ".metrics.json") as f:
            res[tag + "_metrics"] = json.load(f)
    capsys.readouterr()
    got, want = _flat(res["port"]), _flat(res["jax"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.startswith("gt_") or k.startswith(("in_", "smpl")):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)
        elif source == "int8" and k.startswith("pred_angles"):
            d = np.abs(got[k] - want[k])
            assert d.mean() < 0.15 * want[k].std(), (k, d.mean())
        else:
            assert _rel(got[k], want[k]) < (0.02 if "j2d" in k else 0.1), (k, _rel(got[k],
                                                                                 want[k]))
    assert list(res["port_metrics"]) == list(res["jax_metrics"])
    for split, m in res["jax_metrics"].items():
        for k, v in m.items():
            assert abs(res["port_metrics"][split][k] - v) <= 0.1 * abs(v) + 1e-3, (split, k)
