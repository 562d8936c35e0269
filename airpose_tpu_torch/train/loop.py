"""Train and eval steps of the model families (port of
airpose_tpu/train/loop.py:21-222).

``make_twoview_step_fns`` (the two-view models) and
``make_singleview_step_fns`` (hmr, copenet_singleview, muhmr) return
``train_step(state, batch, generator) → (state, metrics)`` and
``eval_step(state, batch) → (metrics, predictions)``.
The model is applied with the state's tensors (``torch.func.functional_call``),
so the state is what the step reads and writes, as in the JAX package:
the forward, the loss, one backward, then the optimizer, all in place. The
generator (on the batch's device) draws the dropout masks and, with
``cfg.smpltrans_noise_sigma``, the noise of the IEF translation init.
The train step's parts run inside ``record_function`` spans (forward,
backward, optimizer) that a profiler reads; without one a span costs a few
microseconds of host time.
"""

from typing import Dict, Optional

import torch
from torch.func import functional_call
from torch.profiler import record_function

from .. import resolve_device
from ..bodymodel.smplx import SMPLXParams
from ..config import TrainConfig
from ..geometry.rotations import rot6d_to_rotmat
from . import losses as L
from .state import AMSGrad, TrainState

Batch = Dict[str, torch.Tensor]


def _maybe_qat(params: Dict[str, torch.Tensor], cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """With ``cfg.qat`` the forward (and its gradient) sees the trunk convs
    fake-quantized through the straight-through estimator, while the
    optimizer updates the latent full-precision weights (ops/qat.py); eval
    applies the same quantizer, so validation scores the deployed network."""
    if not cfg.qat:
        return params
    from ..ops.qat import fake_quant_trunk_params

    return fake_quant_trunk_params(params, cfg.qat_levels)


def _trans_gt(batch: Batch) -> torch.Tensor:
    """GT translation for the IEF init: ``gt_trans`` where the dataset has
    SMPL-X parameter GT, else the cam-frame pelvis of the joints GT."""
    if "gt_trans" in batch:
        return batch["gt_trans"]
    return batch["gt_joints"][:, :, 0]


def _input_trans(batch: Batch, cfg: TrainConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """IEF translation init: fixed [0, 0, 10] or GT + noise, then
    distance-scaled."""
    gt = _trans_gt(batch)
    if cfg.smpltrans_noise_sigma is None:
        t = torch.tensor([0.0, 0.0, 10.0], dtype=gt.dtype, device=gt.device).expand(gt.shape)
    else:
        noise = torch.randn(gt.shape, generator=generator, dtype=gt.dtype, device=gt.device)
        t = gt + cfg.smpltrans_noise_sigma * noise
    return t * cfg.trans_scale


def _eval_input_trans(batch: Batch, cfg: TrainConfig) -> torch.Tensor:
    """Eval-time IEF translation init, pinned to [0, 0, 10] whatever the
    train-time noise: evaluation is deterministic and never reads GT."""
    gt = _trans_gt(batch)
    t = torch.tensor([0.0, 0.0, 10.0], dtype=gt.dtype, device=gt.device).expand(gt.shape)
    return t * cfg.trans_scale


def _step_fns(model: torch.nn.Module, cfg: TrainConfig, tx: AMSGrad, dev: torch.device,
              inputs, loss_from_out, predictions):
    """(train_step, eval_step) of one family: ``inputs(batch, in_trans)``
    gives the model's positional arguments, ``loss_from_out(out, batch)``
    its loss and ``predictions(out)`` what eval_step returns beside the
    metrics."""

    def forward(state: TrainState, batch: Batch, in_trans, train: bool, generator):
        tensors = {**_maybe_qat(state.params, cfg), **state.batch_stats}
        return functional_call(model, tensors, inputs(batch, in_trans),
                               {"iters": cfg.reg_iters, "train": train,
                                "generator": generator})

    def check_device(batch):
        if batch["images"].device.type != dev.type:
            raise ValueError(f"the batch is on {batch['images'].device}, the steps on {dev}")

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator):
        check_device(batch)
        with record_function("forward"):
            in_trans = _input_trans(batch, cfg, generator)
            out = forward(state, batch, in_trans, True, generator)
            total, metrics = loss_from_out(out, batch)
        names = list(state.opt_state["mu"])
        with record_function("backward"):
            grads = torch.autograd.grad(total, [state.params[n] for n in names])
        with record_function("optimizer"):
            tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        check_device(batch)
        out = forward(state, batch, _eval_input_trans(batch, cfg), False, None)
        _, metrics = loss_from_out(out, batch)
        return metrics, predictions(out)

    return train_step, eval_step


def make_twoview_step_fns(model: torch.nn.Module, smplx_params: SMPLXParams,
                          cfg: TrainConfig, tx: AMSGrad, loss=None, device=None):
    """(train_step, eval_step) for AirPoseTwoView or the per-drone
    AirPoseTwoViewSep (the same call). ``loss`` defaults to the
    SMPL-X-parameter-supervised ``twoview_loss``; ``joints_loss`` serves
    joints-only GT. The steps run on ``device`` (CUDA by default; raises
    without it), where ``model`` and ``smplx_params`` must already be.
    eval_step's predictions are pred_trans (B, 2, 3), pred_rotmat
    (B, 2, 22, 3, 3) and pred_betas (B, 2, 10)."""
    dev = resolve_device(device)
    if loss is None:
        loss = L.twoview_loss

    def predictions(out):
        pose = out.pose
        return {"pred_trans": pose[..., :3] / cfg.trans_scale,
                "pred_rotmat": rot6d_to_rotmat(pose[..., 3:].reshape(pose.shape[0], 2, 22, 6)),
                "pred_betas": out.betas}

    return _step_fns(
        model, cfg, tx, dev, lambda batch, in_trans: (batch["images"], batch["bb"], in_trans),
        lambda out, batch: loss(out.pose, out.betas, batch, smplx_params, cfg.loss,
                                cfg.trans_scale),
        predictions)


# each single-view family's forward arguments from the two-view batch layout
_SINGLEVIEW_INPUTS = {
    "hmr": lambda batch, in_trans: (batch["images"][:, 0],),
    "copenet_singleview": lambda batch, in_trans: (batch["images"][:, 0], batch["bb"][:, 0],
                                                   in_trans[:, 0]),
    "muhmr": lambda batch, in_trans: (batch["images"],),
}


def make_singleview_step_fns(model: torch.nn.Module, smplx_params: SMPLXParams,
                             cfg: TrainConfig, tx: AMSGrad, family: str,
                             vertex_mask: Optional[torch.Tensor] = None,
                             use_kernels: bool = True, device=None):
    """(train_step, eval_step) for the single-view families ('hmr',
    'copenet_singleview') and 'muhmr' on the two-view batch layout: view 0
    where the family sees one view. ``vertex_mask`` (V,) restricts the
    vertex term to the body; ``use_kernels=False`` skins with the plain
    version. eval_step returns the model's output beside the metrics. The
    steps run on ``device`` as make_twoview_step_fns's do."""
    dev = resolve_device(device)
    if family not in _SINGLEVIEW_INPUTS:
        raise ValueError(f"not a single-view family: {family}")

    def loss_from_out(out, batch):
        if family == "copenet_singleview":
            return L.singleview_loss(out.pose, out.betas, batch, smplx_params, cfg.loss,
                                     cfg.trans_scale, vertex_mask=vertex_mask,
                                     use_kernels=use_kernels)
        fn = L.hmr_loss if family == "hmr" else L.muhmr_loss
        return fn(out.pose6d, out.betas, out.cam, batch, smplx_params, cfg.loss, cfg.img_res,
                  vertex_mask=vertex_mask, use_kernels=use_kernels)

    return _step_fns(model, cfg, tx, dev, _SINGLEVIEW_INPUTS[family], loss_from_out,
                     lambda out: out)
