"""The training step of record: one ``train_step`` object driven back to
back on batches of the synthetic two-view set, cycling through a pool of
distinct batches that stay on the device.

Set-up builds the configuration's model from the seed's weights, its
TrainState and AMSGrad (``create_train_state``) and its train step
(``make_twoview_step_fns`` for AirPose, ``make_singleview_step_fns(family=
"hmr")`` on view 0 for HMR), then drives that same step through its first
three steps on the pool's first three batches: they warm it up and are
what the check follows. It reads each step's loss, the first step's
gradient norm of every parameter from the optimizer's first moment
(m₁ = (1 − b1)·g), and the norm of each parameter's change over the three
steps. The window then continues the same state; its rate counts every
row of every step over the window, which ends in a ``synchronize``.

Once the window (and the traced window) has closed, the same object takes
one more step through the same call, on the next batch of the window's
cycle: the path that the window ran, in the state it left. The check reads
that step's loss, its gradient (from the first moment before and after:
g = (m − b1·m₀)/(1 − b1)) and each parameter's change.

The check runs the plain reference's three steps from the same weights, on
the same batches, with the dropout masks drawn in the same order from a
generator seeded alike, and compares: each step's loss, each parameter's
gradient norm and each parameter's change (the worst parameter, as a share
of the larger of its own norm and the median parameter's). It then takes
the program's parameters and AMSGrad state from before the step after the
window (the hundreds of steps between cannot be followed in a run's time),
runs the reference's step from them on the same batch and dropout seed, and
compares the same three numbers. A loss that is not finite anywhere in the
window makes the run not correct.
"""

import dataclasses
import time
from typing import Dict, List

import torch

from ..harness import Check, Window, sync
from ..inputs import training_pool
from ..reference import model as ref
from ..reference.weights import make_smplx, make_state
from . import program_body, program_model

STEPS_FOLLOWED = 3


@dataclasses.dataclass
class State:
    train_step: object
    ts: object            # the program's TrainState
    pool: List[Dict[str, torch.Tensor]]
    generator: torch.Generator
    steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    readings: dict = dataclasses.field(default_factory=dict)


def build_step(ctx, model, body, tcfg):
    """The program's (TrainState, train_step) for the configuration."""
    from airpose_tpu_torch.train.loop import make_singleview_step_fns, make_twoview_step_fns
    from airpose_tpu_torch.train.state import create_train_state

    ts, tx = create_train_state(model, ctx.cfg["optimizer"]["lr"])
    if ctx.cfg["family"] == "hmr":
        step, _ = make_singleview_step_fns(model, body, tcfg, tx, "hmr", device=ctx.device)
    else:
        step, _ = make_twoview_step_fns(model, body, tcfg, tx, device=ctx.device)
    return ts, step


def half_batch(step):
    """A planted fault: the step sees the first half of each batch."""
    def broken(ts, batch, generator):
        n = batch["images"].shape[0] // 2
        return step(ts, {k: v[:n] for k, v in batch.items()}, generator)
    return broken


def setup(ctx) -> State:
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.models import MODEL_REGISTRY

    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    ctx.phase("imports")
    weights = make_state(cfg, ctx.seed_of(1), dev)
    ctx.phase("weights")
    model = program_model(MODEL_REGISTRY[cfg["family"]], weights, dev,
                          getattr(torch, cfg["trunk_dtype"]))
    ctx.phase("model")
    raw_body = make_smplx(ctx.seed_of(2), s["num_vertices"], dev)
    body = program_body(raw_body)
    pool = training_pool(ctx.seed_of(3), raw_body, s["pool_batches"], s["batch"], s["crop"], dev)
    ctx.phase("body_and_inputs")
    tcfg = TrainConfig(model=cfg["family"], img_res=s["crop"], batch_size=s["batch"],
                       qat=ctx.control == "int8")
    ts, step = build_step(ctx, model, body, tcfg)
    if ctx.fault == "half_batch":
        step = half_batch(step)
    st = State(step, ts, pool, torch.Generator(device=dev).manual_seed(ctx.seed_of(4)))
    first = {n: p.detach().clone() for n, p in ts.params.items()}
    losses, b1 = [], cfg["optimizer"]["b1"]
    for k in range(STEPS_FOLLOWED):
        losses.append(one_step(st))
        if k == 0:
            with torch.no_grad():
                mu = ts.opt_state["mu"]
                grad = dict(zip(mu, torch._foreach_norm(list(mu.values()))))
    with torch.no_grad():
        names = list(first)
        change = torch._foreach_norm(torch._foreach_sub([ts.params[n] for n in names],
                                                        [first[n] for n in names]))
    ctx.phase("first_steps")
    st.readings = {"losses": [float(x) for x in losses],
                   "grad_norms": {n: float(v) / (1.0 - b1) for n, v in grad.items()},
                   "change_norms": {n: float(v) for n, v in zip(names, change)}}
    return st


def one_step(st: State) -> torch.Tensor:
    st.ts, metrics = st.train_step(st.ts, st.pool[st.steps % len(st.pool)], st.generator)
    st.steps += 1
    return metrics["loss"]


def window(ctx, st: State, seconds: float) -> Window:
    sync(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        st.losses.append(one_step(st))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(ctx.device)
    elapsed = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(st.losses))).sum())
    return Window({"train_frames_per_s": n * ctx.sizes["batch"] / elapsed}, attempted=n,
                  failed=failed, seconds=elapsed, units=n)


def unit(ctx, st: State) -> None:
    one_step(st)


def step_after_window(ctx, st: State) -> dict:
    """One more step of the window's object on the window's next batch, the
    dropout generator seeded from the run's seed → the state before it (for
    the reference), the batch, and the program's readings of the step."""
    ts, b1 = st.ts, ctx.cfg["optimizer"]["b1"]
    names = list(ts.params)
    with torch.no_grad():
        before = {"params": {n: ts.params[n].clone() for n in names},
                  "count": ts.opt_state["count"],
                  **{k: {n: ts.opt_state[k][n].clone() for n in names}
                     for k in ("mu", "nu", "nu_max")}}
    batch = st.pool[st.steps % len(st.pool)]
    st.generator.manual_seed(ctx.seed_of(5))
    loss = one_step(st)
    with torch.no_grad():
        mu, mu0 = [st.ts.opt_state["mu"][n] for n in names], list(before["mu"].values())
        grad = torch._foreach_norm(torch._foreach_sub(mu, torch._foreach_mul(mu0, b1)))
        change = torch._foreach_norm(torch._foreach_sub([st.ts.params[n] for n in names],
                                                        list(before["params"].values())))
    return {"before": before, "batch": batch,
            "readings": {"loss": float(loss),
                         "grad_norms": {n: float(v) / (1.0 - b1) for n, v in zip(names, grad)},
                         "change_norms": {n: float(v) for n, v in zip(names, change)}}}


def evidence(ctx, st: State) -> dict:
    """The followed steps' readings, the step after the window and the
    window's losses that are not finite; the program's state and pool go."""
    nonfinite = int((~torch.isfinite(torch.stack(st.losses))).sum()) if st.losses else 0
    return {"readings": st.readings, "batches": st.pool[:STEPS_FOLLOWED],
            "after": step_after_window(ctx, st), "nonfinite": nonfinite}


def gaps(prog: Dict[str, float], want: Dict[str, float], keep=None):
    """The worst parameter's |‖prog‖ − ‖ref‖| over the larger of its
    reference norm and the median parameter's; ``keep`` limits the
    parameters compared. → (worst gap, the three worst parameters)."""
    names = [n for n in want if keep is None or n in keep]
    med = float(torch.tensor([want[n] for n in names]).median())
    g = {n: abs(prog[n] - want[n]) / max(want[n], med) for n in names}
    nan = [n for n, v in g.items() if v != v]
    order = nan + sorted((n for n in g if n not in nan), key=lambda n: -g[n])
    return (float("nan") if nan else g[order[0]]), {
        n: [g[n], prog[n], want[n]] for n in order[:3]}


def moved(grad_norms: Dict[str, float]) -> set:
    """The parameters whose reference gradient is at least a thousandth of
    the median parameter's; the others move by round-off alone under
    AMSGrad."""
    med = float(torch.tensor(list(grad_norms.values())).median())
    return {n for n, g in grad_norms.items() if g >= 1e-3 * med}


def check(ctx, ev: dict) -> List[Check]:
    """The plain reference's first three steps from the same weights and
    batches, then its step from the program's state before the step after
    the window. Parameters that ``moved`` leaves out are not compared in
    the change."""
    ref.no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = make_state(cfg, ctx.seed_of(1), dev)
    body = make_smplx(ctx.seed_of(2), s["num_vertices"], dev)
    params = ref.trainable(sd)
    for p in params.values():
        p.requires_grad_(True)
    first = {n: p.detach().clone() for n, p in params.items()}
    o = cfg["optimizer"]
    opt = ref.AMSGrad(params, o["lr"], o["b1"], o["b2"], o["eps"])
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_of(4))
    losses, grad_norms = [], {}
    for k, batch in enumerate(ev["batches"]):
        loss = ref.train_loss(sd, cfg, body, batch, gen)
        grads = torch.autograd.grad(loss, list(params.values()))
        if k == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(params, grads)}
        opt.step(params, dict(zip(params, grads)))
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - first[n])) for n in params}
    keep = moved(grad_norms)
    del params, first, opt

    got = ev["readings"]
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], losses)]
    grad_gap, grad_worst = gaps(got["grad_norms"], grad_norms)
    change_gap, change_worst = gaps(got["change_norms"], change, keep)
    last = follow_step_after_window(ctx, sd, body, ev["after"])
    lim = ctx.cell.workload["limits"]
    return [Check("loss1_gap", steps[0], lim.get("loss1_gap"),
                  {"steps": steps, "program": got["losses"], "reference": losses}),
            Check("grad_norm_gap", grad_gap, lim.get("grad_norm_gap"), grad_worst),
            Check("change_norm_gap", change_gap, lim.get("change_norm_gap"),
                  dict(change_worst, left_out=len(grad_norms) - len(keep))),
            *last,
            Check("nonfinite_losses", ev["nonfinite"], 0)]


def follow_step_after_window(ctx, sd, body, after: dict) -> List[Check]:
    """The reference's step from the program's parameters and AMSGrad state
    before the step after the window, on the same batch with the dropout
    generator seeded alike; → the ``last_*`` checks."""
    cfg, dev, before = ctx.cfg, ctx.device, after["before"]
    sd = {**sd, **{n: p.clone() for n, p in before["params"].items()}}
    params = ref.trainable(sd)
    for p in params.values():
        p.requires_grad_(True)
    o = cfg["optimizer"]
    opt = ref.AMSGrad(params, o["lr"], o["b1"], o["b2"], o["eps"])
    opt.t = before["count"]
    opt.m, opt.v, opt.vmax = (dict(before[k]) for k in ("mu", "nu", "nu_max"))
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_of(5))
    loss = ref.train_loss(sd, cfg, body, after["batch"], gen)
    grads = torch.autograd.grad(loss, list(params.values()))
    grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(params, grads)}
    opt.step(params, dict(zip(params, grads)))
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - before["params"][n]))
              for n in params}
    keep = moved(grad_norms)
    got = after["readings"]
    loss = float(loss.detach())
    grad_gap, grad_worst = gaps(got["grad_norms"], grad_norms)
    change_gap, change_worst = gaps(got["change_norms"], change, keep)
    lim = ctx.cell.workload["limits"]
    return [Check("last_loss_gap", abs(got["loss"] - loss) / abs(loss), lim.get("last_loss_gap"),
                  {"program": got["loss"], "reference": loss, "step": before["count"] + 1}),
            Check("last_grad_norm_gap", grad_gap, lim.get("last_grad_norm_gap"), grad_worst),
            Check("last_change_norm_gap", change_gap, lim.get("last_change_norm_gap"),
                  dict(change_worst, left_out=len(grad_norms) - len(keep)))]
