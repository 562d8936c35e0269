"""Training state and optimizer (port of airpose_tpu/train/state.py).

The optimizer is the reference's Adam with AMSGrad, weight decay 0, lr 5e-5,
as ``optax.amsgrad(b1=0.9, b2=0.999, eps=1e-8)`` computes it: the running
maximum is taken of the *bias-corrected* second moment,

    m ← b1·m + (1 − b1)·g          v ← b2·v + (1 − b2)·g²
    m̂ = m / (1 − b1ᵗ)              v̂ = v / (1 − b2ᵗ)
    v̂max ← max(v̂max, v̂)           p ← p − lr · m̂ / (√v̂max + eps)

``torch.optim.Adam(amsgrad=True)`` takes the maximum of the raw v and
divides by √(1 − b2ᵗ) after it, which differs once v shrinks. The bias
corrections are computed in f32, as optax does: 1 − b2 in f32 is 1.3e-5
away from 1e-3, which would otherwise move the first steps by 6e-6.
"""

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

REG_ONLY_MODULES = ("core", "core0", "core1")  # fc1/fc2/dec heads live here


@dataclasses.dataclass
class TrainState:
    """``params`` and ``batch_stats`` map names to the model's own tensors
    (``named_parameters`` and the BatchNorm running statistics); the train
    step updates them, and ``opt_state``, in place."""

    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: dict


class AMSGrad:
    """optax-style AMSGrad over named parameters: ``init(params)`` →
    state, ``update(grads, state, params)`` applies one step in place.
    Parameters for which ``trainable(name)`` is false get no state and no
    update (optax's ``set_to_zero`` branch), so they stay bit-equal."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 trainable: Optional[Callable[[str], bool]] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.trainable = trainable or (lambda name: True)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        names = [n for n in params if self.trainable(n)]
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in names}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros(), "nu_max": zeros()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]) -> None:
        names = list(state["mu"])
        g = [grads[n] for n in names]
        mu, nu, nu_max = ([state[k][n] for n in names] for k in ("mu", "nu", "nu_max"))
        state["count"] += 1
        t = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        torch._foreach_lerp_(mu, g, 1.0 - self.b1)          # b1·m + (1 − b1)·g
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, 1.0 - self.b2)   # b2·v + (1 − b2)·g²
        nu_hat = torch._foreach_div(nu, bc2)
        torch._foreach_maximum_(nu_max, nu_hat)
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, denom)
        # p − lr · m̂ / (√v̂max + eps), m̂ = m / (1 − b1ᵗ)
        torch._foreach_add_([params[n] for n in names], step,
                            alpha=-self.lr / bc1)


def make_optimizer(lr: float, train_reg_only: bool = False) -> AMSGrad:
    """AMSGrad at ``lr``; with ``train_reg_only`` only the regressor heads
    (``core``) are updated, the trunk's parameters stay as they are (its
    BatchNorm running statistics still move, the forward being in train
    mode)."""
    if not train_reg_only:
        return AMSGrad(lr)
    return AMSGrad(lr, trainable=lambda name: name.split(".")[0] in REG_ONLY_MODULES)


def model_variables(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"params", "batch_stats"}`` of ``model``: its own parameters and
    BatchNorm running statistics by name (not copies)."""
    return {"params": dict(model.named_parameters()),
            "batch_stats": {n: b for n, b in model.named_buffers() if n.rsplit(".", 1)[-1]
                            in ("running_mean", "running_var", "num_batches_tracked")}}


def create_train_state(model: nn.Module, lr: float, train_reg_only: bool = False):
    """(TrainState over ``model``'s own tensors, optimizer)."""
    variables = model_variables(model)
    tx = make_optimizer(lr, train_reg_only)
    return TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"])), tx
