"""One-command dress rehearsal of the full reference workflow on fixtures
(port of airpose_tpu/tools/dress_rehearsal.py).

The reference README's end-to-end contract is: install → preprocess the
dataset → train → evaluate (res_compile) → refine (AirPose+ bundle_adj)
→ deploy (client/server). The released datasets/checkpoints are external
downloads; this module runs the ENTIRE chain on generated fixtures so the
whole pipeline is exercisable (and regression-tested) in one command:

    python -m airpose_tpu_torch.tools.dress_rehearsal --workdir out [--platform cpu]

Stages (each through the port's own CLI entry point, not library shortcuts):
  1. tools/create_aerialpeople      → synthetic AerialPeople dataset
  2. train/trainer                  → smoke-train copenet_twoview
  3. train/checkpoint               → the trainer's last.ckpt → the
                                      reference state dict → a .ckpt file,
                                      loaded back strict with every tensor
                                      equal (the port reads no orbax, so
                                      this is its converter round trip)
  4. eval/compile_results (on-disk) → MPJPE/PA-MPJPE/MPE, f32 AND --int8
  5. tools/synth_real_capture       → synthetic DJI-layout capture
  6. eval/compile_results (real://) → outputs pkl + cross-view metric
  7. synthetic→real fine-tune       → --pretrained_checkpoint (stage-2
                                      ckpt) + --train_reg_only on real://,
                                      then the SAME real:// eval must
                                      improve (ref README.md:117-124)
  8. optim/bundle_adjust            → AirPose+ refinement + trajectory png
  9. serve/benchtest                → served-vs-offline diffs + served FPS
     (9b: the same replay through the native C++ clients' ROI path)
 10. mixed:// train + h36m:// eval  → the h36m/totalcap/mixed families
                                      (generated prebuilt dbs,
                                      tools/synth_mocap_dbs)

Where matplotlib is missing, stage 8 runs the AirPose+ CLI up to its
result pkl and leaves the plot out; where h5py is missing, stage 10 is
left out (H36M's cameras are an HDF5 file). Each prints why. Stages 4 and
9 read stage 3's .ckpt file, as the JAX rehearsal reads its converted
checkpoint.

Prints a metrics table and writes ``rehearsal_summary.json`` with the JAX
rehearsal's keys.
"""

import contextlib
import importlib.util
import io
import json
import os
import os.path as osp
import pickle

import numpy as np
import torch


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _missing(module: str) -> bool:
    return importlib.util.find_spec(module) is None


def run(workdir: str, steps: int = 6, frames: int = 6, subjects: int = 3,
        img_res: int = 64, ba_iters=(5, 10), verts: int = 99,
        batch_size: int = 4, ft_steps: int = None, platform: str = None) -> dict:
    """``platform`` is passed to every CLI as ``--platform`` (the CUDA card
    when None)."""
    if ba_iters[0] < 1:
        raise SystemExit(
            "--ba_iters: the first (stage-1) count must be >= 1 — the "
            "rehearsal's BA health metric is the stage-1 descent")
    plat = ["--platform", platform] if platform else []

    summary = {}
    os.makedirs(workdir, exist_ok=True)

    # ---- 1. dataset creation (the README "preprocess" step) ----
    from .create_aerialpeople import main as create_main

    aerial = osp.join(workdir, "aerialpeople")
    create_main([
        "--out", aerial, "--subjects", str(subjects),
        "--poses-per-subject", "2", "--num-vertices", str(verts),
        "--render-blobs", *plat,
    ])
    print(f"[1/10] dataset created: {aerial}", flush=True)

    # ---- 2. smoke training ----
    from ..train.trainer import main as train_main

    logdir = osp.join(workdir, "logs")
    train_main([
        "--name", "rehearsal", "--version", "0",
        "--model", "copenet_twoview", "--datapath", aerial,
        "--log_dir", logdir, "--batch_size", str(batch_size),
        "--val_batch_size", str(batch_size), "--max_steps", str(steps),
        "--val_every", str(steps), "--img_res", str(img_res),
        "--data_workers", "2", *plat,
    ])
    ckpt_dir = osp.join(logdir, "rehearsal", "version_0", "checkpoints")
    ckpt = osp.join(ckpt_dir, "last.ckpt")
    summary["train_best_val"] = _read_json(
        osp.join(ckpt_dir, "best_val.json"))["best_val"]
    print(f"[2/10] trained {steps} steps → {ckpt}", flush=True)

    # ---- 3. reference-checkpoint round trip on the TRAINED weights ----
    from ..models import MODEL_REGISTRY
    from ..train.checkpoint import load_reference_state_dict, reference_state_dict
    from ..train.state import model_variables

    def loaded(path):
        model = MODEL_REGISTRY["copenet_twoview"]()
        load_reference_state_dict(
            model, torch.load(path, map_location="cpu", weights_only=False),
            "copenet_twoview")
        return model

    trained = loaded(ckpt)
    variables = model_variables(trained)
    exported = osp.join(workdir, "rehearsal_reference.ckpt")
    torch.save({"state_dict": reference_state_dict(
        {**variables["params"], **variables["batch_stats"]}, "copenet_twoview")}, exported)
    a, b = trained.state_dict(), loaded(exported).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    summary["converter_roundtrip_max_err"] = float(max(
        float((a[k] - b[k]).abs().max()) for k in variables["params"]))
    print("[3/10] trained last.ckpt → reference .ckpt → strict load round "
          "trip: tensor-identical", flush=True)

    # ---- 4. on-disk eval, f32 + int8 (JAX's summary keys) ----
    from ..eval.compile_results import main as compile_main

    for tag, extra in (("bf16", []), ("int8", ["--int8"])):
        out_pkl = osp.join(workdir, f"synth_results_{tag}.pkl")
        compile_main([
            "--model", "copenet_twoview", "--torch_ckpt", exported,
            "--datapath", aerial, "--split", "test", "--out", out_pkl,
            "--batch_size", str(batch_size), "--img_res", str(img_res),
            "--synthetic_verts", str(verts), *extra, *plat,
        ])
        summary[f"synth_{tag}"] = _read_json(out_pkl + ".metrics.json")["test"]
    print("[4/10] on-disk eval compiled (f32 + int8)", flush=True)

    # ---- 5+6. synthetic real capture → real:// eval ----
    from .synth_real_capture import write_capture

    real = osp.join(workdir, "real_capture")
    write_capture(real, n_frames=frames)
    real_pkl = osp.join(workdir, "real_results.pkl")
    compile_main([
        "--model", "copenet_twoview", "--torch_ckpt", exported,
        "--datapath", f"real://{real}", "--split", "test",
        "--test_frames", "0", str(frames), "--out", real_pkl,
        "--batch_size", str(min(batch_size, frames)),
        "--img_res", str(img_res), "--synthetic_verts", str(verts), *plat,
    ])
    summary["real"] = _read_json(real_pkl + ".metrics.json")["test"]
    print(f"[5-6/10] real-layout capture evaluated ({frames} frames)",
          flush=True)

    # ---- 7. the README synthetic→real fine-tune chain ----
    # Resume from the synthetic checkpoint, freeze all but the regressor
    # heads, fine-tune self-supervised on the real capture (ref
    # README.md:117-124 + copenet_real/copenet_twoview.py:361-373), then
    # re-run the SAME real:// eval. At demonstration scale (ft_steps >=
    # 24, the default CLI run) the eval loss MUST improve on the
    # un-fine-tuned checkpoint (train frames == eval frames here). Below
    # that budget the number is recorded, not judged: a handful of
    # reg-only steps also drags the trunk's BN running stats toward the
    # capture, and the heads cannot re-adapt to the moved features that
    # fast — the same recorded-not-judged posture as BA stage 2 below.
    if ft_steps is None:
        ft_steps = max(48, 8 * steps)
    ft_logs = osp.join(workdir, "logs_ft")
    train_main([
        "--name", "ft", "--version", "0", "--model", "copenet_twoview",
        "--datapath", f"real://{real}", "--train_frames", "0", str(frames),
        "--test_frames", "0", str(frames), "--log_dir", ft_logs,
        "--pretrained_checkpoint", ckpt, "--train_reg_only",
        "--lr", "5e-4", "--batch_size", str(min(batch_size, frames)),
        "--val_batch_size", str(min(batch_size, frames)),
        "--max_steps", str(ft_steps), "--val_every", str(ft_steps),
        "--img_res", str(img_res), "--data_workers", "2", *plat,
    ])
    ft_ckpt = osp.join(ft_logs, "ft", "version_0", "checkpoints", "last.ckpt")
    ft_pkl = osp.join(workdir, "real_results_ft.pkl")
    compile_main([
        "--model", "copenet_twoview", "--ckpt", ft_ckpt,
        "--datapath", f"real://{real}", "--split", "test",
        "--test_frames", "0", str(frames), "--out", ft_pkl,
        "--batch_size", str(min(batch_size, frames)),
        "--img_res", str(img_res), "--synthetic_verts", str(verts), *plat,
    ])
    summary["real_ft"] = _read_json(ft_pkl + ".metrics.json")["test"]
    if ft_steps >= 24:
        assert summary["real_ft"]["loss"] < summary["real"]["loss"], (
            f"synthetic→real fine-tune did not improve the real:// "
            f"self-supervised eval loss: {summary['real']['loss']:.4f} → "
            f"{summary['real_ft']['loss']:.4f}")
    print(f"[7/10] synthetic→real fine-tune ({ft_steps} reg-only steps): "
          f"real:// eval loss {summary['real']['loss']:.4f} → "
          f"{summary['real_ft']['loss']:.4f}", flush=True)

    # ---- 8. AirPose+ ----
    from ..optim.bundle_adjust import build_parser, optimize
    from ..optim.bundle_adjust import main as ba_main

    ba_out = osp.join(workdir, "airpose_plus")
    ba_argv = [
        "--datapath", f"real://{real}", "--airpose-pkl", real_pkl,
        "--split", "test", "--test_frames", "0", str(frames),
        "--out", ba_out, "--synthetic_verts", str(verts),
        "--iters1", str(ba_iters[0]), "--iters2", str(ba_iters[1]), *plat,
    ]
    plot = not _missing("matplotlib")
    if plot:
        ba_main(ba_argv)
    else:
        optimize(build_parser().parse_args(ba_argv))
    with open(osp.join(ba_out, "airpose_plus_test.pkl"), "rb") as f:
        ba = pickle.load(f)
    # Health metric = STAGE-1 descent (z frozen): it is meaningful under
    # the rehearsal's RANDOM VPoser prior. Stage 2 optimizes THROUGH the
    # prior's decoder, so its final loss is recorded but not judged.
    stage1 = ba["trace"][:ba_iters[0]]
    summary["ba_stage1_first"] = float(stage1[0])
    summary["ba_stage1_final"] = float(stage1[-1])
    summary["ba_loss_final"] = float(ba["trace"][-1])
    if plot:
        assert osp.exists(osp.join(ba_out, "cam_trajectory_test.png"))
    else:
        print("[8/10] matplotlib is not installed here: the trajectory plot "
              "cam_trajectory_test.png is left out", flush=True)
    print("[8/10] AirPose+ refinement done (stage-1 loss "
          f"{summary['ba_stage1_first']:.3f} → "
          f"{summary['ba_stage1_final']:.3f}; full-run final "
          f"{summary['ba_loss_final']:.3f}, random-prior stage 2 — "
          "meaningful only with --vposer_ckpt)", flush=True)

    # ---- 9. served-vs-offline benchtest + served FPS ----
    from ..serve.benchtest import ensure_client_built
    from ..serve.benchtest import main as bench_main

    def benchtest(extra, prefix=""):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_main([
                "--datapath", f"real://{real}", "--frames", "0", str(frames),
                "--torch-ckpt", exported,
                "--batch_size", str(min(batch_size, frames)),
                "--img_res", str(img_res), *extra, *plat,
            ])
        print(buf.getvalue(), end="", flush=True)
        for line in buf.getvalue().splitlines():
            if line.startswith("benchtest_"):
                k, v = line.split(": ")
                summary[prefix + k] = float(v)

    benchtest(["--rate", "--rate-warmup", "2"])
    assert summary["benchtest_absdiff_pose_m1"] < 1e-3
    print("[9/10] serve benchtest done", flush=True)

    # ---- 9b. native C++ client replay (if a toolchain is available) ----
    # Full frames + ROI messages through the C++ clients' own
    # crop/resize/bb path — the complete reference rosbag-replay analog.
    if ensure_client_built():
        benchtest(["--native-roi"], prefix="native_")
        # client-side crop parity is ≤1 uint8 step; the network-amplified
        # residual stays far below pose-meaningful scales
        assert summary["native_benchtest_absdiff_pose_m1"] < 2e-2
        print("[9b/10] native C++ client replay done", flush=True)
    else:
        print("[9b/10] native client not buildable here — skipped", flush=True)

    # ---- 10. cross-dataset families: mixed:// train + h36m:// eval ----
    # Generated h36m/totalcap prebuilt dbs (tools/synth_mocap_dbs) feed
    # the heterogeneous mixed:// trainer (joints-GT + SMPL-GT losses
    # dispatched per batch) and the H36M-protocol eval.
    if _missing("h5py"):
        print("[10/10] h5py is not installed here: H36M's cameras are an "
              "HDF5 file, so mixed:// train + h36m:// eval are left out",
              flush=True)
    else:
        from .synth_mocap_dbs import write_h36m, write_totalcap

        h36m = write_h36m(osp.join(workdir, "h36m"), n=3)
        tc = write_totalcap(osp.join(workdir, "totalcap"), n=5)
        mix_logs = osp.join(workdir, "logs_mixed")
        train_main([
            "--name", "mixed", "--version", "0", "--model", "copenet_twoview",
            "--datapath", f"mixed://h36m={h36m},totalcap={tc}",
            "--log_dir", mix_logs, "--batch_size", "2", "--val_batch_size", "1",
            "--max_steps", "2", "--val_every", "2", "--img_res", str(img_res),
            "--data_workers", "1", *plat,
        ])
        mixed_ckpt = osp.join(mix_logs, "mixed", "version_0", "checkpoints",
                              "last.ckpt")
        h36m_pkl = osp.join(workdir, "h36m_results.pkl")
        compile_main([
            "--model", "copenet_twoview", "--ckpt", mixed_ckpt,
            "--datapath", f"h36m://{h36m}", "--split", "test",
            "--out", h36m_pkl, "--batch_size", "2", "--img_res", str(img_res),
            "--synthetic_verts", str(verts), *plat,
        ])
        summary["h36m"] = _read_json(h36m_pkl + ".metrics.json")["test"]
        assert all(np.isfinite(v) for v in summary["h36m"].values())
        print("[10/10] mixed:// train + h36m:// protocol eval done", flush=True)

    # ---- table + summary ----
    print("\n=== dress rehearsal metrics ===")
    for k, v in summary.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                print(f"  {k}/{kk:28s} {vv:.4f}")
        else:
            print(f"  {k:38s} {v:.6f}")
    with open(osp.join(workdir, "rehearsal_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {osp.join(workdir, 'rehearsal_summary.json')}")
    return summary


def main(argv=None):
    import argparse

    from .. import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=6,
                   help="training smoke steps")
    p.add_argument("--frames", type=int, default=6,
                   help="synthetic real-capture frames")
    p.add_argument("--subjects", type=int, default=3)
    p.add_argument("--img_res", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--verts", type=int, default=99,
                   help="synthetic body-model vertex count")
    p.add_argument("--ba_iters", type=int, nargs=2, default=(5, 10))
    p.add_argument("--ft_steps", type=int, default=None,
                   help="stage-7 fine-tune steps (default max(48, 8*steps); "
                        "the loss-improvement assertion arms at >= 24)")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device of every stage (the CUDA card by default; "
                        "raises without it)")
    args = p.parse_args(argv)
    resolve_device(args.platform)
    run(args.workdir, steps=args.steps, frames=args.frames,
        subjects=args.subjects, img_res=args.img_res, verts=args.verts,
        ba_iters=tuple(args.ba_iters), batch_size=args.batch_size,
        ft_steps=args.ft_steps, platform=args.platform)


if __name__ == "__main__":
    main()
