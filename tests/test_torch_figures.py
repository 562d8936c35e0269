"""Port parity of the figure tooling (airpose_tpu_torch.eval.figures vs
airpose_tpu.eval.figures, on the CPU): the metric table string for string,
the relative-camera trajectory at atol 1e-6 (the same float64 numpy and
scipy arithmetic on both sides), and the CLI's metrics.md and plot."""

import json
import os
import pickle

import numpy as np

from airpose_tpu.eval import figures as jfig
from airpose_tpu_torch.eval import figures as tfig


def _outputs(rng, n=6, batches=2):
    return [{"output": {
        "pred_angles0": rng.normal(0, 0.3, (n, 22, 3)).astype(np.float32),
        "pred_angles1": rng.normal(0, 0.3, (n, 22, 3)).astype(np.float32),
        "pred_smpltrans0": rng.normal(0, 1, (n, 3)).astype(np.float32),
        "pred_smpltrans1": rng.normal(0, 1, (n, 3)).astype(np.float32),
    }} for _ in range(batches)]


def test_metric_table_matches_jax():
    metrics = {"a/test": {"mpjpe0": 0.05, "mpe0": 1.25, "pa_mpjpe0": 0.031},
               "b/train": {"mpjpe0": 0.5, "loss": 12.0},
               "c/test_cam0": {"camera": 0.0, "focal_x": 1537.0, "loss": float("nan")}}
    assert tfig.metric_table(metrics) == jfig.metric_table(metrics)


def test_relative_camera_trajectory_matches_jax():
    outputs = _outputs(np.random.default_rng(0))
    got = tfig.relative_camera_trajectory(outputs)
    assert got.shape == (12, 3)
    np.testing.assert_allclose(got, jfig.relative_camera_trajectory(outputs), atol=1e-6)
    # a rig by hand: cam1 one metre to the right of cam0, same orientation
    a = np.zeros((4, 22, 3), np.float32)
    rig = [{"output": {"pred_angles0": a, "pred_angles1": a,
                       "pred_smpltrans0": np.tile(np.float32([0, 0, 5]), (4, 1)),
                       "pred_smpltrans1": np.tile(np.float32([1, 0, 5]), (4, 1))}}]
    np.testing.assert_allclose(tfig.relative_camera_trajectory(rig),
                               np.tile([-1.0, 0, 0], (4, 1)), atol=1e-6)


def test_figures_cli_matches_jax(tmp_path, capsys):
    """Two outputs pkls, one with its .metrics.json sidecar: the same
    metrics.md and printed table as the JAX CLI, and the trajectory plot."""
    rng = np.random.default_rng(1)
    entries = []
    for name, metrics in (("airpose", {"test": {"mpjpe0": 0.05, "mpe0": 1.25}}),
                          ("other", None)):
        pkl = str(tmp_path / f"{name}.pkl")
        with open(pkl, "wb") as f:
            pickle.dump([_outputs(rng)], f)
        if metrics:
            with open(pkl + ".metrics.json", "w") as f:
                json.dump(metrics, f)
        entries.append(f"{name}={pkl}")
    outs = {}
    for tag, main in (("jax", jfig.main), ("port", tfig.main)):
        outs[tag] = str(tmp_path / tag)
        extra = ["--platform", "cpu"] if tag == "port" else []
        main(["--results", *entries, "--out", outs[tag], *extra])
    printed = capsys.readouterr().out
    tables = [open(os.path.join(outs[t], "metrics.md")).read() for t in ("jax", "port")]
    assert tables[0] == tables[1] and "airpose/test" in tables[1] and "1.2500" in tables[1]
    assert printed.count(tables[1].strip()) == 2
    for t in outs.values():
        assert os.path.getsize(os.path.join(t, "cam_trajectory.png")) > 1000

