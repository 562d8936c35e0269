"""Training-step roofline: decompose the flagship two-view train step (port
of airpose_tpu/tools/train_roofline.py).

The training config of record (batch 30 @224, Adam amsgrad 5e-5, reg_iters
3 — ref copenet/copenet_twoview.py:419-425,655-675) split into trunk
fwd/bwd, IEF+heads, SMPL-X + loss fwd+bwd, optimizer update and residual,
from eight stages each timed on its own.

Method: each stage is a function carry → carry whose hot input depends on
the carry, so every iteration computes from the last one's result. A
stage runs a few warm-up iterations, then ``--length`` iterations between
two CUDA events on the card (the host clock after a synchronize on the
CPU); the result is seconds per iteration. Every stage works on its own
copy of the model and the optimizer state: the ``full``, ``fwd_train``,
``fwdbwd_*`` and ``opt`` stages update BatchNorm statistics or AMSGrad's
state in place.

Usage:
    python -m airpose_tpu_torch.tools.train_roofline [--batch 30] [--img 224]
        [--length 100] [--stages full,fwd_eval,...] [--remat] [--platform cpu]

``--remat`` wraps the trunk in ``torch.utils.checkpoint`` for the
full-step and the fwd+bwd stages (the memory-for-FLOPs trade, measured not
assumed). The trunk runs train-mode BatchNorm, whose forward moves the
running statistics; the recompute in the backward restores them, so a
remat step moves them once, as a step without it does.
"""

import argparse
import contextlib
import copy
import time

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device

ALL_STAGES = (
    "full", "fwd_eval", "fwd_train", "fwdbwd_model", "fwdbwd_trunk",
    "loss_fwd", "loss_fwdbwd", "opt",
)
WARMUP = 2


def time_stage(step, carry, n: int, device, warmup: int = WARMUP) -> float:
    """Seconds per iteration of ``carry = step(carry)`` over ``n``
    iterations after ``warmup``: CUDA events on the card, the host clock
    on the CPU. The last carry must be finite."""
    for _ in range(warmup):
        carry = step(carry)
    if device.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            carry = step(carry)
        stop.record()
        stop.synchronize()
        dt = start.elapsed_time(stop) / 1e3 / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            carry = step(carry)
        dt = (time.perf_counter() - t0) / n
    c = carry[0] if isinstance(carry, tuple) else carry
    assert torch.isfinite(c).all(), "non-finite stage output"
    return dt


def remat_forward(trunk):
    """``trunk.forward`` under ``torch.utils.checkpoint``: the activations
    are recomputed in the backward. The recompute runs the train-mode
    BatchNorm forward a second time, so it puts back the running
    statistics it moved."""
    forward = trunk.forward
    stats = [b for n, b in trunk.named_buffers() if n.endswith(("running_mean", "running_var"))]

    def run(x, part, train, calls):
        calls[0] += 1
        if calls[0] == 1:
            return forward(x, part, train)
        saved = [b.clone() for b in stats]
        try:
            return forward(x, part, train)
        finally:
            with torch.no_grad():
                for b, s in zip(stats, saved):
                    b.copy_(s)

    def remat(x, part="full", train=False):
        if not torch.is_grad_enabled():
            return forward(x, part, train)
        return checkpoint(run, x, part, train, [0], use_reentrant=False)

    return remat


@contextlib.contextmanager
def rematerialized(trunk, on: bool = True):
    """Within the block, calls of ``trunk`` go through ``remat_forward``."""
    if not on:
        yield
        return
    trunk.forward = remat_forward(trunk)
    try:
        yield
    finally:
        del trunk.forward


def build(batch_size: int, img: int, device=None):
    """Model (bf16 trunk), SMPL-X, cfg and the batch — the training config
    of record on synthetic fixtures (full-size 10,475-vertex body), on
    ``device`` (CUDA by default)."""
    from ..bodymodel import synthetic_smplx_params
    from ..config import TrainConfig
    from ..data import make_synthetic_dataset
    from ..models import AirPoseTwoView

    dev = resolve_device(device)
    smplx_params = synthetic_smplx_params().to(dev)
    cfg = TrainConfig(model="copenet_twoview", img_res=img)
    model = AirPoseTwoView(iters=cfg.reg_iters, dtype=torch.bfloat16).to(dev)
    batch = make_synthetic_dataset(smplx_params, batch_size, seed=0, img_size=img)
    return model, smplx_params, cfg, batch


def stage_fns(model, smplx_params, cfg, batch, stages, remat: bool = False):
    """{stage: (step, initial carry)} for the stages named, each over its
    own deep copy of ``model`` (and a fresh optimizer state)."""
    from ..models import mean_init_state
    from ..train import losses as L
    from ..train.loop import make_twoview_step_fns
    from ..train.state import create_train_state

    dev = batch["images"].device
    B, _, H, W, _ = batch["images"].shape
    in_trans = torch.full((B, 2, 3), 0.5, device=dev)
    x2 = batch["images"].reshape(2 * B, H, W, 3)
    gen = torch.Generator(device=dev).manual_seed(1)
    zero = torch.zeros((), device=dev)
    out = {}

    def hot_batch(c):
        return {**batch, "images": batch["images"] + c * 1e-6}

    def consumed(c, grads):
        # every gradient reduced into the carry
        return c + sum(g.float().mean() for g in grads if g is not None) * 1e-12

    def full(m):
        state, tx = create_train_state(m, cfg.lr)
        train_step, _ = make_twoview_step_fns(m, smplx_params, cfg, tx, device=dev)

        def step(c):
            with rematerialized(m.trunk, remat):
                _, metrics = train_step(state, hot_batch(c), gen)
            return metrics["loss"] * 0 + c + 1e-9
        return step

    def fwd(train):
        def make(m):
            @torch.no_grad()
            def step(c):
                o = m(batch["images"] + c * 1e-6, batch["bb"], in_trans, iters=cfg.reg_iters,
                      train=train, generator=gen if train else None)
                return c + (o.pose.mean() + o.betas.mean()) * 1e-9
            return step
        return make

    def fwdbwd_model(m):
        params = list(m.parameters())

        def step(c):
            with rematerialized(m.trunk, remat):
                o = m(batch["images"] + c * 1e-6, batch["bb"], in_trans,
                      iters=cfg.reg_iters, train=True, generator=gen)
                g = torch.autograd.grad(o.pose.sum() + o.betas.sum(), params,
                                        allow_unused=True)
            return consumed(c, g)
        return step

    def fwdbwd_trunk(m):
        params = list(m.trunk.parameters())

        def step(c):
            with rematerialized(m.trunk, remat):
                xf = m.trunk(x2 + c * 1e-6, train=True)
                g = torch.autograd.grad(xf.float().sum(), params)
            return consumed(c, g)
        return step

    def opt(m):
        state, tx = create_train_state(m, cfg.lr)
        grads0 = {n: torch.ones_like(p) * 1e-6 for n, p in state.params.items()}
        first = next(iter(state.params.values()))

        def step(c):
            tx.update({n: g + c * 1e-9 for n, g in grads0.items()}, state.opt_state,
                      state.params)
            return c + first.mean() * 1e-12
        return step

    model_stages = {"full": full, "fwd_eval": fwd(False), "fwd_train": fwd(True),
                    "fwdbwd_model": fwdbwd_model, "fwdbwd_trunk": fwdbwd_trunk, "opt": opt}
    for name, make in model_stages.items():
        if name in stages:
            out[name] = (make(copy.deepcopy(model)), zero)

    # the model's real IEF init (a fabricated [1,0,0,0,1,0] 6D is
    # degenerate under the column-major (3,2) reshape)
    mean_pose6d, mean_shape, _ = mean_init_state((B, 2), dev)
    pose0 = torch.cat([torch.full((B, 2, 3), 0.5, device=dev), mean_pose6d], -1)
    betas0 = mean_shape.contiguous()

    def loss_val(pose, betas, c):
        return L.twoview_loss(pose + c * 1e-6, betas, batch, smplx_params, cfg.loss,
                              cfg.trans_scale)[0]

    if "loss_fwd" in stages:
        @torch.no_grad()
        def loss_fwd(c):
            return c + loss_val(pose0, betas0, c) * 1e-12

        out["loss_fwd"] = (loss_fwd, zero)

    if "loss_fwdbwd" in stages:
        def loss_fwdbwd(c):
            p, b = pose0.clone().requires_grad_(), betas0.clone().requires_grad_()
            gp, gb = torch.autograd.grad(loss_val(p, b, c), (p, b))
            return c + gp.mean() * 1e-12 + gb.mean() * 1e-12

        out["loss_fwdbwd"] = (loss_fwdbwd, zero)

    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=30)
    p.add_argument("--img", type=int, default=224)
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--stages", default=",".join(ALL_STAGES))
    p.add_argument("--remat", action="store_true",
                   help="torch.utils.checkpoint around the trunk in the full "
                        "and fwd+bwd stages")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (the CUDA card by default; raises without it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    model, smplx_params, cfg, batch = build(args.batch, args.img, dev)
    B = args.batch
    stages = args.stages.split(",")
    results = {name: time_stage(fn, c0, args.length, dev)
               for name, (fn, c0) in stage_fns(model, smplx_params, cfg, batch, stages,
                                               args.remat).items()}

    # ---- report ----
    tag = " (remat)" if args.remat else ""
    print(f"\ntrain roofline{tag}: B={B} @{args.img}, reg_iters="
          f"{cfg.reg_iters}, {args.length} iterations a stage, "
          f"device={dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    for k in ALL_STAGES:
        if k in results:
            print(f"  {k:14s} {results[k]*1e3:8.2f} ms/iter")
    r = results
    if all(k in r for k in
           ("full", "fwdbwd_model", "fwdbwd_trunk", "loss_fwdbwd", "opt")):
        print("derived decomposition of the full step:")
        print(f"  trunk fwd+bwd       {r['fwdbwd_trunk']*1e3:8.2f} ms")
        print(f"  IEF+heads fwd+bwd   {(r['fwdbwd_model']-r['fwdbwd_trunk'])*1e3:8.2f} ms")
        print(f"  SMPLX+loss fwd+bwd  {r['loss_fwdbwd']*1e3:8.2f} ms")
        print(f"  optimizer (amsgrad) {r['opt']*1e3:8.2f} ms")
        resid = r["full"] - r["fwdbwd_model"] - r["loss_fwdbwd"] - r["opt"]
        print(f"  residual (loss-chain coupling, BN stat plumbing)"
              f" {resid*1e3:8.2f} ms")
        print(f"  full step           {r['full']*1e3:8.2f} ms "
              f"({2*B/r['full']:.0f} imgs/s, {B/r['full']:.0f} two-view samples/s)")
    return results


if __name__ == "__main__":
    main()
