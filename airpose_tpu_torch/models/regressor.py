"""Iterative-error-feedback (IEF) regressor head (port of
airpose_tpu/models/regressor.py): concat(conditioning) → fc1(1024) →
dropout → fc2(1024) → dropout → one residual delta per head, all in f32."""

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

DROPOUT = 0.5  # after fc1 and fc2, active in train mode only
MEAN_PARAMS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                           "assets", "smpl_mean_params.npz")


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    """flax's default Dense init: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 − rate and
    scale the kept values by 1 / (1 − rate), the mask drawn from
    ``generator`` (on ``h``'s device)."""
    keep = 1.0 - rate
    mask = torch.empty_like(h).bernoulli_(keep, generator=generator)
    return h * mask / keep


class RegressorCore(nn.Module):
    """One IEF step's MLP. Returns one delta per head. In train mode its
    dropout draws the masks from the generator the caller passes."""

    def __init__(self, in_dim: int, head_dims: Sequence[int],
                 head_names: Sequence[str], generator=None):
        super().__init__()
        self.head_names = tuple(head_names)
        self.fc1 = nn.Linear(in_dim, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        for fc in (self.fc1, self.fc2):
            _lecun_normal_(fc.weight, generator)
            nn.init.zeros_(fc.bias)
        for d, name in zip(head_dims, head_names):
            head = nn.Linear(1024, d)
            nn.init.xavier_uniform_(head.weight, gain=0.01, generator=generator)
            nn.init.zeros_(head.bias)
            self.add_module(name, head)

    def forward(self, xc: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        if train and generator is None:
            raise ValueError("RegressorCore: train-mode dropout needs a torch.Generator")
        h = self.fc1(xc)
        if train:
            h = dropout(h, DROPOUT, generator)
        h = self.fc2(h)
        if train:
            h = dropout(h, DROPOUT, generator)
        return tuple(getattr(self, name)(h) for name in self.head_names)


def load_mean_params(path: str = MEAN_PARAMS):
    """Mean SMPL parameters used as the IEF initialization: (pose_6d (144,),
    shape (10,), cam (3,)) float32 numpy arrays."""
    d = np.load(path)
    return tuple(np.asarray(d[k], dtype=np.float32) for k in ("pose", "shape", "cam"))
