"""The port's one-command dress rehearsal (airpose_tpu_torch/tools/
dress_rehearsal.py) runs the whole reference workflow through the port's
own CLIs on the CPU, with the JAX rehearsal's asserts and summary keys
(tests/test_dress_rehearsal.py): a fast cut at the JAX test's sizes, and
the whole run at the CLI's defaults (stage 7's loss-improvement assert
armed at 48 fine-tune steps), which is slow as the JAX rehearsal is."""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from airpose_tpu_torch.tools.dress_rehearsal import main, run

KEYS = ("train_best_val", "converter_roundtrip_max_err", "synth_bf16", "synth_int8", "real",
        "real_ft", "ba_stage1_first", "ba_stage1_final", "ba_loss_final",
        "benchtest_absdiff_pose_m1", "benchtest_served_fps", "h36m")


@pytest.fixture(autouse=True)
def _drop_tmp_path(request):
    """Deletes each test's tmp_path when it ends: its checkpoints (~100-400
    MB each) would otherwise stay in the base temps pytest keeps."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _check(summary, wd):
    for key in KEYS:
        assert key in summary, key
    assert np.isfinite(summary["h36m"]["mpjpe0"])
    assert np.isfinite(summary["h36m"]["pa_mpjpe1"])
    assert summary["converter_roundtrip_max_err"] == 0.0
    assert np.isfinite(summary["synth_bf16"]["mpjpe0"])
    assert np.isfinite(summary["synth_int8"]["mpjpe0"])
    assert np.isfinite(summary["real"]["crossview_consistency"])
    assert np.isfinite(summary["real_ft"]["loss"])
    assert np.isfinite(summary["real_ft"]["crossview_consistency"])
    assert np.isfinite(summary["ba_stage1_first"])
    assert np.isfinite(summary["ba_stage1_final"])
    assert np.isfinite(summary["ba_loss_final"])
    assert summary["benchtest_absdiff_pose_m1"] < 1e-3
    assert summary["benchtest_served_fps"] > 0
    if "native_benchtest_absdiff_pose_m1" in summary:
        assert summary["native_benchtest_absdiff_pose_m1"] < 2e-2
    with open(os.path.join(wd, "rehearsal_summary.json")) as f:
        assert json.load(f).keys() == summary.keys()
    assert os.path.exists(os.path.join(wd, "airpose_plus", "cam_trajectory_test.png"))


def test_dress_rehearsal_fast_cut(tmp_path):
    """tests/test_dress_rehearsal.py's sizes: stage 7's improvement assert
    is not armed below 24 fine-tune steps, as in JAX; every other assert
    is."""
    wd = str(tmp_path / "wd")
    summary = run(wd, steps=2, frames=4, subjects=2, img_res=64, ba_iters=(2, 3), verts=60,
                  batch_size=2, ft_steps=8, platform="cpu")
    _check(summary, wd)


@pytest.mark.slow
def test_dress_rehearsal_cli_defaults(tmp_path):
    """The module's entry point at its defaults (6 steps, 6 frames, 48
    reg-only fine-tune steps: stage 7's assert armed)."""
    wd = str(tmp_path / "wd")
    main(["--workdir", wd, "--platform", "cpu"])
    with open(os.path.join(wd, "rehearsal_summary.json")) as f:
        summary = json.load(f)
    _check(summary, wd)
    assert summary["real_ft"]["loss"] < summary["real"]["loss"]


def test_dress_rehearsal_without_matplotlib_or_h5py(tmp_path, monkeypatch, capsys):
    """Where matplotlib and h5py are missing (the card machine), stage 8
    runs AirPose+ up to its result pkl and leaves the plot out, and stage
    10 is left out, each with a printed reason; the ba_iters guard holds."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name in ("matplotlib", "h5py")
                        else real(name, *a))
    with pytest.raises(SystemExit, match="ba_iters"):
        run(str(tmp_path / "x"), ba_iters=(0, 1), platform="cpu")
    wd = str(tmp_path / "wd")
    summary = run(wd, steps=1, frames=2, subjects=2, img_res=32, ba_iters=(1, 1), verts=60,
                  batch_size=2, ft_steps=1, platform="cpu")
    out = capsys.readouterr().out
    assert "the trajectory plot cam_trajectory_test.png is left out" in out
    assert "mixed:// train + h36m:// eval are left out" in out
    assert "h36m" not in summary and np.isfinite(summary["ba_loss_final"])
    assert os.path.exists(os.path.join(wd, "airpose_plus", "airpose_plus_test.pkl"))
    assert not os.path.exists(os.path.join(wd, "airpose_plus", "cam_trajectory_test.png"))
