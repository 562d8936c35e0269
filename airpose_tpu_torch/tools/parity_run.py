"""Released-asset parity runner (port of airpose_tpu/tools/parity_run.py) —
the BASELINE.md north star in one command.

The reference's published capability is its released checkpoints +
precalculated result pkls (ref README.md:22-27; the consuming contract is
scripts/copenet_synth_res_compile.py:25-64: ``res = trainer.test(...)``
saved as ``[test_batches, train_batches]``, each batch ``{"output":
{pred_angles0/1, pred_smpltrans0/1, pred_betas0/1, ...}}``). This tool chains
the port's stages so the moment the assets are mounted the north-star run is
ONE command:

    python -m airpose_tpu_torch.tools.parity_run \\
        --model copenet_twoview \\
        --torch-ckpt epoch=205...ckpt \\
        --precalc epoch=205....pkl \\
        --datapath /data/agora_copenet_uniform_new_cropped \\
        --smplx-model-dir /data/smplx/models/smplx \\
        --workdir parity_out

Stages:
  1. loud asset validation (ckpt present, precalc pkl matches the res
     contract, datapath/SMPL-X layout present)
  2. a strict load of the reference .ckpt into the port's model
     (train.checkpoint.load_reference_state_dict; the port reads no orbax,
     so there is nothing to convert)
  3. eval on the dataset through the port's compile_results (deterministic
     crops), on ``--platform`` (the card by default)
  4. comparison: per-field mean/max |Δ| of our outputs vs the precalculated
     ones over aligned frames, AND both sides' predictions scored with the
     SAME metric code (MPJPE/PA-MPJPE/MPE) against the dataset GT our eval
     collected

``--datapath real://<dir>`` switches to the REAL released bundles: the
precalc pkls follow the same suffixed-field contract, there is no 3D GT,
and the score recomputed for both sides is the robust cross-view
consistency over the capture's extrinsics + detector mask. ``--model hmr``
with real:// consumes the per-camera pkl PAIR (``<base>0``/``<base>1``) —
pass the base name as ``--precalc``.

The field diffs are taken in float64 for fields under 100 MB (JAX's runner
casts both sides to float32 first, which hides agreement below f32's
resolution) and in float32, chunked, above that (the vertex fields of a
whole released split); the report names each field's precision.

Writes ``<workdir>/parity_report.json`` and prints the table.
"""

import argparse
import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from .. import resolve_device

REQUIRED_OUTPUT_KEYS = {
    "twoview": ("pred_angles0", "pred_angles1", "pred_smpltrans0",
                "pred_smpltrans1", "pred_betas0", "pred_betas1"),
    "single": ("pred_angles", "pred_smpltrans", "pred_betas"),
}
F64_FIELD_BYTES = 100 * 2 ** 20  # fields up to this size (as f64) diff in f64


def family_kind(model: str) -> str:
    return "twoview" if model == "copenet_twoview" else "single"


def _np(t):
    """torch tensor / array → numpy (the released pkls store torch CPU tensors)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_precalc(path: str, split_index: int = 0,
                 required=REQUIRED_OUTPUT_KEYS["twoview"]):
    """Load a released precalculated-results pkl and return the requested
    split's outputs as {field: (N, ...) numpy}. The file is either
    ``[test_batches, train_batches]`` (the res_compile layout) or a bare
    batch list. Validates the contract loudly."""
    with open(path, "rb") as f:
        res = pickle.load(f)
    if not isinstance(res, (list, tuple)) or len(res) == 0:
        raise ValueError(f"{path}: expected a list (res_compile layout), "
                         f"got {type(res).__name__}")
    if isinstance(res[0], dict) and "output" in res[0]:
        batches = res
    else:
        if split_index >= len(res):
            raise ValueError(f"{path}: has {len(res)} splits, asked for "
                             f"split index {split_index}")
        batches = res[split_index]
    if (not isinstance(batches, (list, tuple)) or len(batches) == 0
            or not isinstance(batches[0], dict)
            or "output" not in batches[0]):
        raise ValueError(
            f"{path}: split {split_index} is not a list of "
            f"{{'output': {{...}}}} batches (the trainer.test layout)")
    keys = set(batches[0]["output"].keys())
    missing = [k for k in required if k not in keys]
    if missing:
        raise ValueError(
            f"{path}: precalc outputs missing {missing}; present: "
            f"{sorted(keys)}")
    fields = {}
    for k in sorted(keys):
        try:
            fields[k] = np.concatenate(
                [_np(b["output"][k]) for b in batches])
        except ValueError as e:
            raise ValueError(f"{path}: field '{k}' does not concatenate "
                             f"across batches: {e}") from None
    return fields


def compare_outputs(ours: dict, theirs: dict):
    """Per-field mean/max |Δ| over the aligned frame prefix of the shared
    fields, in float64 for fields under ``F64_FIELD_BYTES`` and in float32,
    chunked, above it (each entry's ``precision`` says which). Row-count
    mismatches are expected (the reference evaluates with drop_last batches;
    this framework covers every frame) and reported, not fatal."""
    shared = sorted(set(ours) & set(theirs))
    report = {}
    for k in shared:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        n = min(a.shape[0], b.shape[0])
        if a.shape[1:] != b.shape[1:]:
            report[k] = {"error": f"shape mismatch {a.shape} vs {b.shape}"}
            continue
        a, b = a[:n], b[:n]
        wide = a.size * 8 <= F64_FIELD_BYTES
        dtype = np.float64 if wide else np.float32
        a, b = a.astype(dtype, copy=False), b.astype(dtype, copy=False)
        tot, mx, cnt = 0.0, 0.0, 0
        for s in range(0, n, 512):
            d = np.abs(a[s:s + 512].astype(np.float64) - b[s:s + 512].astype(np.float64))
            tot += float(d.sum())
            mx = max(mx, float(d.max())) if d.size else mx
            cnt += d.size
        report[k] = {"n": int(n), "mean_abs": tot / max(cnt, 1), "max_abs": mx,
                     "precision": "float64" if wide else "float32"}
    return report


def _rotmats(angles, n, dev):
    """(N, 22, 3) or (N, 66) axis-angles → (n, 22, 3, 3) rotations."""
    from ..geometry.rotations import batch_rodrigues

    a = torch.from_numpy(np.asarray(angles[:n], np.float32)).to(dev)
    return batch_rodrigues(a.reshape(-1, 3)).reshape(n, -1, 3, 3)


def metrics_from_fields(fields: dict, gt: dict, smplx_params, dev):
    """Score a side's predictions with the port's metric code
    (eval/metrics.twoview_eval_metrics) against the dataset GT — the same
    formulas for both sides, so the metric deltas isolate the MODEL."""
    from ..eval.metrics import twoview_eval_metrics

    n = min(fields["pred_angles0"].shape[0], gt["gt_pose_rotmat"].shape[0])

    def t(a):
        return torch.from_numpy(np.asarray(a[:n], np.float32)).to(dev)

    pred_rotmat = torch.stack([_rotmats(fields["pred_angles0"], n, dev),
                               _rotmats(fields["pred_angles1"], n, dev)], dim=1)
    pred_betas = torch.stack([t(fields["pred_betas0"]), t(fields["pred_betas1"])], dim=1)
    pred_trans = torch.stack([t(fields["pred_smpltrans0"]), t(fields["pred_smpltrans1"])],
                             dim=1)
    with torch.no_grad():
        m = twoview_eval_metrics(smplx_params, pred_rotmat, pred_betas, pred_trans,
                                 t(gt["gt_pose_rotmat"]), t(gt["gt_orient"]),
                                 t(gt["gt_betas"]), t(gt["gt_trans"]))
    return {k: float(v) for k, v in m.items()}


def real_crossview(fields: dict, ds, smplx_params, dev) -> float:
    """Robust cross-view consistency of a side's predictions over the
    capture's extrinsics + detector mask — the reference's real-data
    accuracy proxy, the eval CLI's own code path
    (compile_results.robust_crossview_consistency)."""
    from ..eval.compile_results import robust_crossview_consistency

    n = min(fields["pred_angles0"].shape[0], ds.extr.shape[1])
    with torch.no_grad():
        pred_rotmat = torch.stack([_rotmats(fields["pred_angles0"], n, dev),
                                   _rotmats(fields["pred_angles1"], n, dev)], dim=1)
    pred_betas = np.stack([fields["pred_betas0"][:n], fields["pred_betas1"][:n]], axis=1)
    extr = np.stack([ds.extr[0, :n], ds.extr[1, :n]], axis=1)
    conf = ds.opose[:, :n, :, 2].sum(axis=2)
    err = ~((conf[0] == 0) & (conf[1] == 0))
    return robust_crossview_consistency(smplx_params, pred_rotmat.cpu().numpy(), pred_betas,
                                        extr, err)


def _suffix_cams(per_cam) -> dict:
    """[{field: arr} cam0, {field: arr} cam1] → {field+cam: arr}."""
    return {f"{k}{cam}": v for cam, fields in enumerate(per_cam)
            for k, v in fields.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="copenet_twoview",
                   choices=("copenet_twoview", "muhmr", "hmr", "copenet_singleview"))
    p.add_argument("--torch-ckpt", required=True, help="released reference Lightning .ckpt")
    p.add_argument("--precalc", required=True,
                   help="released precalculated-results .pkl from the same archive")
    p.add_argument("--datapath", required=True,
                   help="the released synthetic dataset root (agora_copenet_* layout), or "
                        "real://<capture>")
    p.add_argument("--smplx-model-dir", default=None,
                   help="released SMPLX_*.npz dir; omit only for fixture runs (synthetic "
                        "body model, parity NOT meaningful)")
    p.add_argument("--synthetic_verts", type=int, default=99,
                   help="fixture body-model size when --smplx-model-dir is absent")
    p.add_argument("--vposer_ckpt", default=None)
    p.add_argument("--workdir", required=True)
    p.add_argument("--split", default="test", choices=("test", "train"))
    p.add_argument("--test_frames", type=int, nargs=2, default=(8000, 15000),
                   help="real:// frame range (the reference real test split)")
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--img_res", type=int, default=224)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (the CUDA card by default; raises without it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    os.makedirs(args.workdir, exist_ok=True)

    # ---- 1. loud asset validation ----
    is_real = args.datapath.startswith("real://")
    data_dir = args.datapath.split("://", 1)[-1]
    is_real_hmr = is_real and args.model == "hmr"
    precalc_paths = ([args.precalc + "0", args.precalc + "1"]
                     if is_real_hmr else [args.precalc])
    for path, what in ([(args.torch_ckpt, "--torch-ckpt"), (data_dir, "--datapath")]
                       + [(pp, "--precalc") for pp in precalc_paths]):
        if not osp.exists(path):
            raise SystemExit(f"{what}: {path} does not exist")
    if is_real and args.model not in ("copenet_twoview", "hmr"):
        raise SystemExit("real:// parity supports the two RELEASED real bundles: "
                         "copenet_twoview and hmr (ref README.md:28-29)")
    if is_real and args.split != "test":
        raise SystemExit("real:// parity runs the test split — the reference's real "
                         "analysis is defined on frames 8000:15000 "
                         "(copenet_real_res_compile.py:107-116); set --test_frames to "
                         "move the window")
    kind = family_kind(args.model)
    split_index = 0 if args.split == "test" else 1
    if is_real_hmr:
        theirs = _suffix_cams([
            load_precalc(pp, split_index=split_index, required=REQUIRED_OUTPUT_KEYS["single"])
            for pp in precalc_paths])
        first_key = "pred_angles0"
    else:
        theirs = load_precalc(args.precalc, split_index=split_index,
                              required=REQUIRED_OUTPUT_KEYS[kind])
        first_key = REQUIRED_OUTPUT_KEYS[kind][0]
    n_ref = theirs[first_key].shape[0]
    if is_real:
        from ..data.real import validate_capture_layout

        validate_capture_layout(data_dir)
        print("[1/4] capture first contact OK: machine_{1,2} layout complete", flush=True)
    else:
        from ..data.aerialpeople import AerialPeopleDataset

        ds_probe = AerialPeopleDataset(data_dir, args.split)
        print(f"[1/4] dataset first contact OK: {len(ds_probe)} {args.split} samples, "
              "sample-0 schema + paths resolve", flush=True)
        del ds_probe
    print(f"[1/4] assets validated: precalc has {n_ref} {args.split} frames, fields "
          f"{sorted(theirs)[:8]}…", flush=True)

    # ---- 2. strict load of the released checkpoint ----
    from ..models import MODEL_REGISTRY
    from ..train.checkpoint import load_reference_state_dict

    blob = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    model = MODEL_REGISTRY[args.model]()
    load_reference_state_dict(model, blob, args.model)
    n_tensors = len(model.state_dict())
    del model, blob
    print(f"[2/4] {args.torch_ckpt} loads strict into the port's {args.model} "
          f"({n_tensors} tensors)", flush=True)

    # ---- 3. our eval over the released dataset ----
    from ..eval.compile_results import main as compile_main

    ours_pkl = osp.join(args.workdir, f"ours_{args.split}.pkl")
    cmd = ["--model", args.model, "--torch_ckpt", args.torch_ckpt,
           "--datapath", args.datapath, "--split", args.split,
           "--out", ours_pkl, "--batch_size", str(args.batch_size),
           "--img_res", str(args.img_res), "--platform", dev.type]
    if args.model == "copenet_twoview":
        # the released twoview precalc pkls carry the body-derived fields
        cmd += ["--save-full"]
    if is_real:
        cmd += ["--test_frames", str(args.test_frames[0]), str(args.test_frames[1])]
    if args.smplx_model_dir:
        cmd += ["--smplx_model_dir", args.smplx_model_dir]
    else:
        print("WARNING: no --smplx-model-dir — running on the SYNTHETIC body model; field "
              "diffs remain meaningful, MPJPE does not", flush=True)
        cmd += ["--synthetic_verts", str(args.synthetic_verts)]
    if args.vposer_ckpt:
        cmd += ["--vposer_ckpt", args.vposer_ckpt]
    compile_main(cmd)

    def read_pkl_fields(path):
        with open(path, "rb") as f:
            batches = pickle.load(f)[0]
        return {k: np.concatenate([_np(b["output"][k]) for b in batches])
                for k in batches[0]["output"]}

    with open(ours_pkl + ".metrics.json") as f:
        metrics_json = json.load(f)
    if is_real_hmr:
        ours = _suffix_cams([read_pkl_fields(ours_pkl + "0"), read_pkl_fields(ours_pkl + "1")])
        our_metrics = {f"cam{c}_{k}": v for c in (0, 1) for k, v in
                       metrics_json[f"{args.split}_cam{c}"].items()}
    else:
        ours = read_pkl_fields(ours_pkl)
        our_metrics = metrics_json[args.split]
    n_ours = ours[first_key].shape[0]
    print(f"[3/4] our eval done: {n_ours} frames", flush=True)

    # ---- 4. comparison ----
    from ..bodymodel import load_smplx_npz, synthetic_smplx_params

    field_report = compare_outputs(ours, theirs)
    report = {"fields": field_report, "ours_metrics": our_metrics,
              "n_ours": int(n_ours), "n_precalc": int(n_ref),
              "field_precision": f"float64 up to {F64_FIELD_BYTES} bytes a field, "
                                 "float32 above"}

    def body_model():
        smplx = (load_smplx_npz(args.smplx_model_dir) if args.smplx_model_dir
                 else synthetic_smplx_params(num_vertices=args.synthetic_verts))
        return smplx.to(dev)

    if is_real:
        # no 3D GT on the real path: the recomputed score for both sides is
        # the robust cross-view consistency over the capture
        from ..data import CopenetRealDataset

        smplx_params = body_model()
        ds = CopenetRealDataset(data_dir, frame_range=range(*args.test_frames))
        if is_real_hmr:
            our_metrics["crossview_consistency"] = real_crossview(ours, ds, smplx_params, dev)
        report["precalc_metrics"] = {
            "crossview_consistency": real_crossview(theirs, ds, smplx_params, dev)}
        report["metric_deltas"] = {
            "crossview_consistency": our_metrics["crossview_consistency"]
            - report["precalc_metrics"]["crossview_consistency"]}
        report["ours_metrics"] = our_metrics
    elif kind == "twoview" and all(k in ours for k in ("gt_angles0", "gt_smpltrans0")):
        # score the PRECALC predictions with the port's metric code against
        # the GT our eval collected (twoview only)
        smplx_params = body_model()
        n = ours["gt_angles0"].shape[0]
        with torch.no_grad():
            gt_rm = _rotmats(np.asarray(ours["gt_angles0"], np.float32)[:, 1:], n, dev)
        gt = {
            "gt_pose_rotmat": gt_rm.cpu().numpy(),
            "gt_orient": np.concatenate([_np(ours["smplorient_rel0"]),
                                         _np(ours["smplorient_rel1"])], axis=1
                                        ).astype(np.float32),
            "gt_betas": np.zeros((n, 10), np.float32),  # the zero-betas eval quirk
            "gt_trans": np.stack([ours["gt_smpltrans0"], ours["gt_smpltrans1"]],
                                 axis=1).astype(np.float32),
        }
        report["precalc_metrics"] = metrics_from_fields(theirs, gt, smplx_params, dev)
        report["metric_deltas"] = {k: our_metrics[k] - report["precalc_metrics"][k]
                                   for k in our_metrics if k in report["precalc_metrics"]}

    print("\n=== parity report ===")
    for k, v in field_report.items():
        if "error" in v:
            print(f"  {k:22s} {v['error']}")
        else:
            print(f"  {k:22s} n={v['n']:5d}  mean|Δ| {v['mean_abs']:.6f}  "
                  f"max|Δ| {v['max_abs']:.6f}  ({v['precision']})")
    print(f"  ours metrics:    {our_metrics}")
    if "precalc_metrics" in report:
        print(f"  precalc metrics: {report['precalc_metrics']}")
        print(f"  deltas:          {report['metric_deltas']}")
    out = osp.join(args.workdir, "parity_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
