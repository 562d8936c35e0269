"""Activation-QAT scale-posture experiment: dynamic abs-max vs FROZEN
calibrated scales, judged under the deployed int8 trunk (port of
airpose_tpu/tools/qat_posture.py).

`--qat_act` trains with dynamic per-batch abs-max scales while deployment
uses static calibrated ones (ops/int8_trunk.calibrate_act_scales). This
tool quantifies that train/deploy mismatch: from one pre-trained state it
fine-tunes three arms for the same step budget —

  ptq      no fine-tune (the deployment baseline)
  bf16_ft  the control: the same steps, no fake-quant
  dynamic  --qat_act's posture: act_fq = levels (per-batch abs-max)
  frozen   --qat_act_frozen's posture: act_fq = (levels, calibrated table)

— and evaluates every arm under the DEPLOYED int8 trunk
(``twoview_int8_forward``, whose convs are the int8 conv kernel on the
card) with the SAME static table (weights requantized per arm; deployment
ships the table with the checkpoint). ``--calib_shrink`` scales the table
down to model an unrepresentative calibration set (shrink < 1 → the
deployed grid CLIPS, the regime dynamic abs-max cannot represent at train
time). Each arm fine-tunes its own copy of the model and of the optimizer
state: the port's train step updates both in place.

Usage:
    python -m airpose_tpu_torch.tools.qat_posture [--platform cpu]
        [--calib_shrink 1.0] [--steps_pre 15] [--steps_ft 20]

Config-of-record mode (batch 30, 224 px, ref copenet_twoview.py:419-425,
655-675):

    python -m airpose_tpu_torch.tools.qat_posture --batch 30 --img 224 \\
        --num_batches 8 --steps_pre 240 --steps_ft 160

``--num_batches > 1`` cycles distinct batches during train/fine-tune and
evaluates every arm on a HELD-OUT batch (the single-batch default keeps
the original overfit-one-batch fixture semantics).
"""

import argparse
import copy

import torch

from .. import resolve_device


def deployed_loss(model, table, batch, smplx_params, cfg) -> float:
    """Eval loss of ``model`` through the DEPLOYED int8 trunk with the
    frozen ``table`` (its weights requantized — exactly what shipping the
    model would do)."""
    from ..ops.int8_trunk import quantize_trunk_params, twoview_int8_forward
    from ..train import losses as L

    qp = quantize_trunk_params(model.trunk.state_dict())
    t = (torch.tensor([0.0, 0.0, 10.0], device=batch["images"].device)
         * cfg.trans_scale).expand(batch["gt_trans"].shape)
    with torch.no_grad():
        out = twoview_int8_forward(model, qp, table, batch["images"], batch["bb"], t)
        loss, _ = L.twoview_loss(out.pose, out.betas, batch, smplx_params,
                                 cfg.loss, cfg.trans_scale)
    return float(loss)


def run_posture(model, smplx_params, train_batches, batch, cfg, steps_pre: int,
                steps_ft: int, calib_shrink: float = 1.0) -> dict:
    """Pre-train ``model`` (f32 copenet_twoview, in place) on
    ``train_batches`` in turn, calibrate the deployment table on the first
    training batch, fine-tune each arm from a copy of the pre-trained model
    and optimizer state, and judge every arm on ``batch`` under the
    deployed int8 trunk → {"bf16": the pre-trained eval loss, "ptq",
    "bf16_ft", "dynamic", "frozen": deployed losses}."""
    from ..models import MODEL_REGISTRY
    from ..ops.int8_trunk import calibrate_act_scales, quantize_trunk_params
    from ..train import create_train_state, make_twoview_step_fns
    from ..train.state import TrainState, model_variables

    dev = batch["images"].device
    nb = len(train_batches)
    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_twoview_step_fns(model, smplx_params, cfg, tx, device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    for s in range(steps_pre):
        train_step(state, train_batches[s % nb], gen)
    bf16_loss = float(eval_step(state, batch)[0]["loss"])

    # calibrate on TRAINING data (the deployment recipe; never the
    # held-out eval batch)
    calib = train_batches[0]["images"]
    with torch.no_grad():
        table = calibrate_act_scales(quantize_trunk_params(model.trunk.state_dict()),
                                     calib.reshape((-1,) + tuple(calib.shape[-3:])))
    table = {k: v * calib_shrink for k, v in table.items()}

    arms = {"ptq": model}
    for name, act_fq in (("bf16_ft", None), ("dynamic", 127.0),
                         ("frozen", (127.0, table))):
        m = MODEL_REGISTRY["copenet_twoview"](iters=cfg.reg_iters, act_fq=act_fq).to(dev)
        m.load_state_dict(model.state_dict())
        variables = model_variables(m)
        st = TrainState(step=state.step, params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=copy.deepcopy(state.opt_state))
        ft_step, _ = make_twoview_step_fns(m, smplx_params, cfg, tx, device=dev)
        g = torch.Generator(device=dev).manual_seed(7)
        for s in range(steps_ft):
            ft_step(st, train_batches[s % nb], g)
        arms[name] = m

    results = {name: deployed_loss(m, table, batch, smplx_params, cfg)
               for name, m in arms.items()}
    return {"bf16": bf16_loss, **results}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--img", type=int, default=64)
    p.add_argument("--verts", type=int, default=222)
    p.add_argument("--steps_pre", type=int, default=15)
    p.add_argument("--steps_ft", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--calib_shrink", type=float, default=1.0,
                   help="scale the calibrated table by this factor "
                        "(<1 models an unrepresentative calibration set)")
    p.add_argument("--num_batches", type=int, default=1,
                   help="distinct training batches to cycle; > 1 also "
                        "holds out one extra batch for evaluation")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (the CUDA card by default; raises without it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    from ..bodymodel import synthetic_smplx_params
    from ..config import TrainConfig
    from ..data import batch_slice, make_synthetic_dataset
    from ..models import MODEL_REGISTRY

    smplx = synthetic_smplx_params(num_vertices=args.verts, seed=3).to(dev)
    nb = max(args.num_batches, 1)
    dataset = make_synthetic_dataset(
        smplx, num_samples=(nb + 1) * args.batch, seed=5, img_size=args.img,
        blob_sigma=3.0)
    train_batches = [batch_slice(dataset, i * args.batch, args.batch, dev)
                     for i in range(nb)]
    # held-out eval batch when cycling several; the single-batch default
    # keeps the original overfit-one-batch fixture semantics
    batch = (batch_slice(dataset, nb * args.batch, args.batch, dev)
             if nb > 1 else train_batches[0])
    cfg = TrainConfig(lr=args.lr, batch_size=args.batch, img_res=args.img)
    model = MODEL_REGISTRY["copenet_twoview"](iters=cfg.reg_iters).to(dev)
    results = run_posture(model, smplx, train_batches, batch, cfg, args.steps_pre,
                          args.steps_ft, args.calib_shrink)

    print(f"\nqat posture experiment: B={args.batch} @{args.img}, "
          f"pre {args.steps_pre} / ft {args.steps_ft} steps over {nb} "
          f"batch(es){' + held-out eval' if nb > 1 else ''}, "
          f"calib_shrink={args.calib_shrink}, device={dev.type}")
    print(f"  bf16 eval loss (pretrain): {results['bf16']:.4f}")
    for name in ("ptq", "bf16_ft", "dynamic", "frozen"):
        print(f"  deployed-int8 eval loss [{name:7s}]: {results[name]:.4f}")
    return results


if __name__ == "__main__":
    main()
