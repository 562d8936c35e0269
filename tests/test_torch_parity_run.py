"""The port's released-asset parity runner (airpose_tpu_torch/tools/
parity_run.py) on fixture bundles, as tests/test_tools.py:310, :465 and :513
run JAX's: a "released-like" reference .ckpt and a precalculated-results pkl
made from the same weights, which the runner must load strictly, evaluate,
align and report with ~0 field diffs and ~0 metric deltas. The fast cuts
(random-init weights, 64² crops, a few frames) run in the tier; the whole
runs (trained weights, the hmr leg, and JAX's runner on the same bundle
with its report held to the port's) are marked ``slow``. Each test deletes
its checkpoints and pkls before it ends."""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from airpose_tpu_torch.eval import compile_results as tcr
from airpose_tpu_torch.models import MODEL_REGISTRY
from airpose_tpu_torch.tools import parity_run
from airpose_tpu_torch.train.checkpoint import reference_state_dict


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (the tier runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_tensorflow(monkeypatch):
    """TensorBoard's writer takes its stub for TensorFlow (importing
    TensorFlow costs ~14 s a process here)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def _released(model_name, path, seed=0):
    """A reference-layout .ckpt of a seeded random-init model."""
    model = MODEL_REGISTRY[model_name](seed=seed)
    torch.save({"state_dict": reference_state_dict(model.state_dict(), model_name)}, path)
    return path


def _aerial(tmp_path):
    from airpose_tpu_torch.tools.create_aerialpeople import main as create_main

    data = str(tmp_path / "aerial")
    create_main(["--out", data, "--subjects", "2", "--poses-per-subject", "2",
                 "--num-vertices", "60", "--render-blobs", "--platform", "cpu"])
    return data


def _precalc(model, ckpt, datapath, out, *extra):
    tcr.main(["--model", model, "--torch_ckpt", ckpt, "--datapath", datapath, "--split",
              "test", "--out", out, "--img_res", "64", "--synthetic_verts", "60",
              "--platform", "cpu", *extra])


def _parity(model, ckpt, precalc, datapath, workdir, *extra):
    return parity_run.main(["--model", model, "--torch-ckpt", ckpt, "--precalc", precalc,
                            "--datapath", datapath, "--synthetic_verts", "60",
                            "--workdir", workdir, "--img_res", "64", "--platform", "cpu",
                            *extra])


def _assert_same(report, keys):
    for k in keys:
        assert report["fields"][k]["max_abs"] < 1e-5, (k, report["fields"][k])
        assert report["fields"][k]["precision"] == "float64"
    assert report["n_ours"] == report["n_precalc"]
    for k, d in report.get("metric_deltas", {}).items():
        assert abs(d) < 1e-4, (k, d)


def test_parity_run_fixture_bundle_fast(tmp_path, capsys):
    """test_tools.py:310's bundle at its fast cut: an AerialPeople fixture
    (2 subjects × 2 poses, 64²), random-init copenet_twoview weights as the
    released .ckpt; the runner's report: pred fields ≤ 1e-5 apart in f64,
    metric deltas ≤ 1e-4 (JAX's bounds), the same frame count; a precalc
    missing a required field is refused."""
    data = _aerial(tmp_path)
    ckpt = _released("copenet_twoview", str(tmp_path / "released.ckpt"))
    precalc = str(tmp_path / "precalc.pkl")
    _precalc("copenet_twoview", ckpt, data, precalc, "--batch_size", "2")
    report = _parity("copenet_twoview", ckpt, precalc, data, str(tmp_path / "parity"),
                     "--batch_size", "2")
    assert "parity report" in capsys.readouterr().out
    _assert_same(report, ("pred_angles0", "pred_smpltrans1", "pred_betas0"))
    assert report["metric_deltas"] and "precalc_metrics" in report
    assert os.path.exists(tmp_path / "parity" / "parity_report.json")

    bad = str(tmp_path / "bad.pkl")
    with open(precalc, "rb") as f:
        res = pickle.load(f)
    for b in res[0]:
        del b["output"]["pred_angles0"]
    with open(bad, "wb") as f:
        pickle.dump(res, f)
    with pytest.raises(ValueError, match="missing.*pred_angles0"):
        parity_run.load_precalc(bad)
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("model", ["copenet_twoview", "hmr"])
def test_parity_run_real_mode_fast(tmp_path, capsys, model):
    """test_tools.py:465 (copenet_twoview) and :513 (hmr's per-camera pkl
    pair) at their fast cut: a 6-frame synthetic DJI capture, random-init
    weights; the fields ≤ 1e-5 apart and the cross-view consistency
    recomputed from the precalc within 1e-4 of the eval CLI's own."""
    from airpose_tpu_torch.tools.synth_real_capture import write_capture

    cap = str(tmp_path / "cap")
    write_capture(cap, n_frames=6)
    ckpt = _released(model, str(tmp_path / "released.ckpt"))
    precalc = str(tmp_path / "precalc.pkl")
    real = ["--test_frames", "0", "6", "--batch_size", "3"]
    _precalc(model, ckpt, f"real://{cap}", precalc, *real)
    report = _parity(model, ckpt, precalc, f"real://{cap}", str(tmp_path / "parity"), *real)
    capsys.readouterr()
    keys = (("pred_angles0", "pred_smpltrans1", "pred_betas0", "pred_pose0")
            if model == "copenet_twoview"
            else ("pred_angles0", "pred_angles1", "pred_smpltrans0", "pred_betas1"))
    _assert_same(report, keys)
    assert "crossview_consistency" in report["metric_deltas"]
    shutil.rmtree(tmp_path)


def test_compare_outputs_precision():
    """f64 below the size limit (a difference under f32's resolution
    survives), f32 chunks above it; row-count mismatches are aligned."""
    a = {"x": np.ones((5, 3)) + 1e-12, "big": np.zeros((3, 4))}
    b = {"x": np.ones((4, 3)), "big": np.zeros((3, 4)), "other": np.zeros(1)}
    rep = parity_run.compare_outputs(a, b)
    assert rep["x"]["n"] == 4 and rep["x"]["precision"] == "float64"
    assert 0 < rep["x"]["max_abs"] < 1e-11
    keep = parity_run.F64_FIELD_BYTES
    parity_run.F64_FIELD_BYTES = 8
    try:
        rep = parity_run.compare_outputs(a, b)
    finally:
        parity_run.F64_FIELD_BYTES = keep
    assert rep["x"]["precision"] == "float32" and rep["x"]["max_abs"] == 0.0
    assert set(rep) == {"x", "big"}


@pytest.mark.slow
def test_parity_run_fixture_bundle(tmp_path, capsys, no_tensorflow):
    """test_tools.py:310 whole: a fixture checkpoint trained 2 steps by the
    port's trainer as the released weights, the twoview and the hmr legs;
    then JAX's runner on the same bundle (its own orbax conversion and
    eval): both reports within JAX's bounds of their precalc, and the
    port's eval within 1e-4 of JAX's eval field by field."""
    import jax  # noqa: F401  (conftest keeps JAX on the CPU)
    from airpose_tpu.tools.parity_run import main as jparity_main

    from airpose_tpu_torch.train.trainer import main as train_main

    data = _aerial(tmp_path)
    logs = str(tmp_path / "logs")
    for name, model, steps in (("p", "copenet_twoview", "2"), ("ph", "hmr", "1")):
        train_main(["--name", name, "--version", "0", "--model", model, "--datapath", data,
                    "--log_dir", logs, "--batch_size", "2", "--val_batch_size", "2",
                    "--max_steps", steps, "--val_every", steps, "--img_res", "64",
                    "--data_workers", "1", "--platform", "cpu"])
    reports = {}
    for name, model, keys in (("p", "copenet_twoview",
                               ("pred_angles0", "pred_smpltrans1", "pred_betas0")),
                              ("ph", "hmr", ("pred_angles", "pred_smpltrans", "pred_betas"))):
        ckpt = os.path.join(logs, name, "version_0", "checkpoints", "last.ckpt")
        precalc = str(tmp_path / f"precalc_{model}.pkl")
        _precalc(model, ckpt, data, precalc, "--batch_size", "2")
        reports[model] = _parity(model, ckpt, precalc, data, str(tmp_path / f"w_{model}"),
                                 "--batch_size", "2")
        _assert_same(reports[model], keys)
        jreport = jparity_main(["--model", model, "--torch-ckpt", ckpt, "--precalc", precalc,
                                "--datapath", data, "--synthetic_verts", "60", "--workdir",
                                str(tmp_path / f"j_{model}"), "--batch_size", "2",
                                "--img_res", "64"])
        # JAX's eval against the port's precalc: the two packages' evals
        assert jreport["n_ours"] == reports[model]["n_ours"]
        for k in keys:
            assert jreport["fields"][k]["max_abs"] < 1e-4, (k, jreport["fields"][k])
    capsys.readouterr()
    shutil.rmtree(tmp_path)
