"""Train and eval steps of the model families (port of
airpose_tpu/train/loop.py).

``make_twoview_step_fns`` (the two-view models) and
``make_singleview_step_fns`` (hmr, copenet_singleview, muhmr) return
``train_step(state, batch, generator) → (state, metrics)`` and
``eval_step(state, batch) → (metrics, predictions)``; the self-supervised
real-data steps ``make_real_twoview_step_fns`` and
``make_real_singleview_step_fns`` (whose train_step also takes the
``view``) return the same pair.
The model is applied with the state's tensors (``torch.func.functional_call``),
so the state is what the step reads and writes, as in the JAX package:
the forward, the loss, one backward, then the optimizer, all in place. The
generator (on the batch's device) draws the dropout masks, with
``cfg.smpltrans_noise_sigma`` the noise of the IEF translation init, and in
the real losses the VPoser latent sample; eval_step draws that sample from
a generator seeded 0, as the JAX package uses ``PRNGKey(0)``.
With a ``mesh`` (parallel/mesh.py) the steps are data-parallel: each rank
takes its rows of the batch (``parallel.shard_batch``), BatchNorm and the
row-weighted means reduce over the data group, the gradients and metrics are
averaged over it, and AMSGrad then runs on every rank alike. Without one (or
at world size 1) a step is what it is in one process.
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
from ..bodymodel.vposer import VPoserParams
from ..config import TrainConfig
from ..geometry.rotations import rot6d_to_rotmat
from ..parallel.mesh import all_reduce_mean, data_parallel
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


def _pinned_trans(batch: Batch, cfg: TrainConfig, generator=None) -> torch.Tensor:
    """IEF translation init of the real-data steps, in train and eval:
    [0, 0, 10], distance-scaled (real batches carry no GT translation)."""
    images = batch["images"]
    return torch.tensor([0.0, 0.0, 10.0 * cfg.trans_scale], dtype=images.dtype,
                        device=images.device).expand(images.shape[0], 2, 3)


def _step_fns(model: torch.nn.Module, cfg: TrainConfig, tx: AMSGrad, dev: torch.device,
              inputs, loss_from_out, predictions,
              init_trans=(_input_trans, _eval_input_trans), mesh=None):
    """(train_step, eval_step) of one family: ``inputs(batch, in_trans)``
    gives the model's positional arguments, ``loss_from_out(out, batch,
    generator)`` its loss and ``predictions(out)`` what eval_step returns
    beside the metrics; ``init_trans`` is the IEF translation init of the
    train step, ``(batch, cfg, generator)``, and of eval_step,
    ``(batch, cfg)``; ``mesh`` makes both steps data-parallel."""
    train_trans, eval_trans = init_trans

    def forward(state: TrainState, batch: Batch, in_trans, train: bool, generator):
        tensors = {**_maybe_qat(state.params, cfg), **state.batch_stats}
        return functional_call(model, tensors, inputs(batch, in_trans),
                               {"iters": cfg.reg_iters, "train": train,
                                "generator": generator})

    def check_device(batch):
        if batch["images"].device.type != dev.type:
            raise ValueError(f"the batch is on {batch['images'].device}, the steps on {dev}")

    def reduced(metrics):
        return dict(zip(metrics, all_reduce_mean(list(metrics.values()), mesh)))

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator):
        check_device(batch)
        names = list(state.opt_state["mu"])
        with data_parallel(mesh):
            with record_function("forward"):
                in_trans = train_trans(batch, cfg, generator)
                out = forward(state, batch, in_trans, True, generator)
                total, metrics = loss_from_out(out, batch, generator)
            with record_function("backward"):
                grads = torch.autograd.grad(total, [state.params[n] for n in names])
                if mesh is not None:
                    grads = all_reduce_mean(grads, mesh)
                    metrics = reduced({k: v.detach() for k, v in metrics.items()})
        with record_function("optimizer"):
            tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        check_device(batch)
        with data_parallel(mesh):
            out = forward(state, batch, eval_trans(batch, cfg), False, None)
            _, metrics = loss_from_out(out, batch, torch.Generator(device=dev).manual_seed(0))
        if mesh is not None:
            metrics = reduced(metrics)
        return metrics, predictions(out)

    return train_step, eval_step


def make_twoview_step_fns(model: torch.nn.Module, smplx_params: SMPLXParams,
                          cfg: TrainConfig, tx: AMSGrad, loss=None, device=None, mesh=None):
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
        lambda out, batch, generator: loss(out.pose, out.betas, batch, smplx_params,
                                           cfg.loss, cfg.trans_scale),
        predictions, mesh=mesh)


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
                             use_kernels: bool = True, device=None, mesh=None):
    """(train_step, eval_step) for the single-view families ('hmr',
    'copenet_singleview') and 'muhmr' on the two-view batch layout: view 0
    where the family sees one view. ``vertex_mask`` (V,) restricts the
    vertex term to the body; ``use_kernels=False`` skins with the plain
    version. eval_step returns the model's output beside the metrics. The
    steps run on ``device`` as make_twoview_step_fns's do."""
    dev = resolve_device(device)
    if family not in _SINGLEVIEW_INPUTS:
        raise ValueError(f"not a single-view family: {family}")

    def loss_from_out(out, batch, generator):
        if family == "copenet_singleview":
            return L.singleview_loss(out.pose, out.betas, batch, smplx_params, cfg.loss,
                                     cfg.trans_scale, vertex_mask=vertex_mask,
                                     use_kernels=use_kernels)
        fn = L.hmr_loss if family == "hmr" else L.muhmr_loss
        return fn(out.pose6d, out.betas, out.cam, batch, smplx_params, cfg.loss, cfg.img_res,
                  vertex_mask=vertex_mask, use_kernels=use_kernels)

    return _step_fns(model, cfg, tx, dev, _SINGLEVIEW_INPUTS[family], loss_from_out,
                     lambda out: out, mesh=mesh)


def make_real_twoview_step_fns(model: torch.nn.Module, smplx_params: SMPLXParams,
                               vposer_params: VPoserParams, cfg: TrainConfig, tx: AMSGrad,
                               use_kernels: bool = True, device=None, mesh=None):
    """(train_step, eval_step) of the self-supervised fine-tune on real
    captures for AirPoseTwoView or AirPoseTwoViewSep: the IEF translation
    init pinned to [0, 0, 10], ``real_twoview_loss`` (2D keypoints and the
    VPoser prior; ``vposer_params`` on ``device``). ``--train_reg_only`` is
    in ``tx``. eval_step returns the model's FullCamOutput beside the
    metrics. The steps run on ``device`` as make_twoview_step_fns's do."""
    dev = resolve_device(device)

    def loss_from_out(out, batch, generator):
        return L.real_twoview_loss(out.pose, out.betas, batch, smplx_params, vposer_params,
                                   cfg.real_loss, generator, cfg.trans_scale,
                                   use_kernels=use_kernels)

    return _step_fns(model, cfg, tx, dev,
                     lambda batch, in_trans: (batch["images"], batch["bb"], in_trans),
                     loss_from_out, lambda out: out, init_trans=(_pinned_trans, _pinned_trans),
                     mesh=mesh)


REAL_SINGLEVIEW_FAMILIES = ("hmr_camswap_difffl", "spin")


def make_real_singleview_step_fns(model: torch.nn.Module, smplx_params: SMPLXParams,
                                  vposer_params: VPoserParams, cfg: TrainConfig, tx: AMSGrad,
                                  family: str = "hmr_camswap_difffl",
                                  use_kernels: bool = True, device=None, mesh=None):
    """(train_step, eval_step) of the real-data single-view fine-tune of the
    HMR model, for the 'hmr_camswap_difffl' variant (the real trainer's
    ``--model hmr``, which alternates the view from step to step) and the
    'spin' baseline (view 0): ``train_step(state, batch, generator, view=0)``
    trains on ``view`` of the two-view batch with ``real_singleview_loss``;
    eval_step scores view 0 and returns the model's WeakCamOutput. The
    steps run on ``device`` as make_twoview_step_fns's do."""
    dev = resolve_device(device)
    if family not in REAL_SINGLEVIEW_FAMILIES:
        raise ValueError(f"not a real single-view family: {family}")

    def view_steps(view):
        def loss_from_out(out, batch, generator):
            return L.real_singleview_loss(out.pose6d, out.betas, out.cam, batch, smplx_params,
                                          vposer_params, cfg.real_loss, generator, view=view,
                                          use_kernels=use_kernels)

        return _step_fns(model, cfg, tx, dev, lambda batch, in_trans: (batch["images"][:, view],),
                         loss_from_out, lambda out: out, init_trans=(_pinned_trans, _pinned_trans),
                         mesh=mesh)

    steps = [view_steps(0), view_steps(1)]

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator, view: int = 0):
        return steps[view][0](state, batch, generator)

    return train_step, steps[0][1]
