"""Figure and metric compilation across models (port of
airpose_tpu/eval/figures.py): the reference's final_res_compile.py and
bundle_adj's trajectory plots, on the host (numpy, scipy, matplotlib).

Reads the outputs-pkl interchange format and its ``.metrics.json`` sidecar
(eval/compile_results.py):
  * the per-model metric table (MPJPE / PA-MPJPE / MPE) as markdown,
    ``metrics.md``;
  * the relative-camera trajectory plot, cam1-wrt-cam0 translation over
    time, AirPose against AirPose+, ``cam_trajectory.png``.

Usage:
  python -m airpose_tpu_torch.eval.figures --results name=path.pkl ... --out dir
      [--platform cpu]
"""

import argparse
import json
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from .. import resolve_device


def metric_table(metrics_by_model: dict) -> str:
    keys = sorted({k for m in metrics_by_model.values() for k in m})
    lines = ["| model | " + " | ".join(keys) + " |",
             "|" + "---|" * (len(keys) + 1)]
    for name, m in metrics_by_model.items():
        lines.append(
            f"| {name} | " + " | ".join(f"{m.get(k, float('nan')):.4f}" for k in keys) + " |")
    return "\n".join(lines)


def relative_camera_trajectory(outputs) -> np.ndarray:
    """outputs pkl (one split) → (N, 3) cam1-wrt-cam0 translations from the
    per-view root poses: T_rel = T0 · T1⁻¹."""
    from scipy.spatial.transform import Rotation

    a0 = np.concatenate([o["output"]["pred_angles0"] for o in outputs])
    a1 = np.concatenate([o["output"]["pred_angles1"] for o in outputs])
    t0 = np.concatenate([o["output"]["pred_smpltrans0"] for o in outputs])
    t1 = np.concatenate([o["output"]["pred_smpltrans1"] for o in outputs])
    N = a0.shape[0]
    out = np.zeros((N, 3))
    for i in range(N):
        T0 = np.eye(4)
        T0[:3, :3] = Rotation.from_rotvec(a0[i, 0]).as_matrix()
        T0[:3, 3] = t0[i]
        T1 = np.eye(4)
        T1[:3, :3] = Rotation.from_rotvec(a1[i, 0]).as_matrix()
        T1[:3, 3] = t1[i]
        out[i] = (T0 @ np.linalg.inv(T1))[:3, 3]
    return out


def plot_trajectories(trajs: dict, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
    for name, t in trajs.items():
        for d, ax in enumerate(axes):
            ax.plot(t[:, d], label=name, alpha=0.8)
    for d, ax in enumerate(axes):
        ax.set_ylabel("xyz"[d] + " (m)")
        ax.legend(loc="upper right")
    axes[-1].set_xlabel("frame")
    fig.suptitle("cam1 wrt cam0 relative translation")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def load_results(entries: List[str]) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """``name=path.pkl`` entries → (each two-view pkl's relative-camera
    trajectory, the metrics of each ``name/split`` from the pkls'
    ``.metrics.json`` sidecars)."""
    trajs, metrics_by_model = {}, {}
    for entry in entries:
        name, path = entry.split("=", 1)
        with open(path, "rb") as f:
            outputs = pickle.load(f)[0]
        if outputs and "pred_angles0" in outputs[0]["output"]:
            trajs[name] = relative_camera_trajectory(outputs)
        mpath = path + ".metrics.json"
        if os.path.exists(mpath):
            with open(mpath) as f:
                for split, m in json.load(f).items():
                    metrics_by_model[f"{name}/{split}"] = m
    return trajs, metrics_by_model


def write_metric_table(metrics_by_model: Dict[str, dict], out_dir: str) -> str:
    """The cross-model metric table, written to ``out_dir/metrics.md``."""
    table = metric_table(metrics_by_model)
    with open(os.path.join(out_dir, "metrics.md"), "w") as f:
        f.write(table + "\n")
    return table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results", nargs="+", required=True,
                   help="name=path.pkl entries (outputs-pkl format)")
    p.add_argument("--out", required=True)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device rule of the port's CLIs (the CUDA card by default; "
                        "raises without it); the figures themselves are host work")
    args = p.parse_args(argv)
    resolve_device(args.platform)

    os.makedirs(args.out, exist_ok=True)
    trajs, metrics_by_model = load_results(args.results)
    plot_trajectories(trajs, os.path.join(args.out, "cam_trajectory.png"))
    print(f"wrote {args.out}/cam_trajectory.png")
    if metrics_by_model:
        print(write_metric_table(metrics_by_model, args.out))


if __name__ == "__main__":
    main()
