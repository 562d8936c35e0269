"""One module per kind of traffic. Each builds the system under test from
the weights and inputs the benchmark made, drives its timed path, and
checks what that path produced against the plain reference."""

import contextlib

import numpy as np
import torch
from torch import nn

from ..reference.smplx import SMPLX_PARENTS


@contextlib.contextmanager
def no_init_draw():
    """Every in-place function of ``nn.init`` does nothing inside: the
    program's constructors draw their weights on the host from a generator
    of their own (1.8 s for AirPose on one host core), which the benchmark's
    weights replace whole."""
    names = [n for n, f in vars(nn.init).items()
             if n.endswith("_") and not n.startswith("_") and callable(f)]
    keep = {n: getattr(nn.init, n) for n in names}
    try:
        for n in names:
            setattr(nn.init, n, lambda t, *a, **k: t)
        yield
    finally:
        for n, fn in keep.items():
            setattr(nn.init, n, fn)


def program_model(cls, state: dict, device, dtype=torch.bfloat16):
    """The program's model class with the benchmark's ``state`` loaded
    strictly, so that every parameter and buffer it saves is the
    benchmark's; its own draw is skipped (``no_init_draw``)."""
    with no_init_draw():
        model = cls(dtype=dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def program_body(body: dict):
    """The program's SMPL-X model tensors from the benchmark's."""
    from airpose_tpu_torch.bodymodel.smplx import SMPLXParams

    return SMPLXParams(parents=SMPLX_PARENTS, faces=np.zeros((1, 3), dtype=np.int64), **body)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def worst_row_rel_l2(a: torch.Tensor, b: torch.Tensor, lead: int) -> float:
    """The largest ‖a − b‖ / ‖b‖ over the rows of the first ``lead`` axes
    (a crop's features, a body's vertices), in float64; NaN where any is."""
    a = a.double().reshape(-1, *a.shape[lead:]).flatten(1)
    b = b.double().reshape(-1, *b.shape[lead:]).flatten(1)
    r = torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1)
    return float("nan") if r.isnan().any() else float(r.max())


def worst_row_cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest 1 − cos(a_i, b_i) over rows i of two (N, D) tensors, in
    float64: 0 where a row points as the reference's does, 1 where the two
    are unrelated; NaN where either holds a NaN."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    c = (a * b).sum(1) / (torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1))
    return float("nan") if c.isnan().any() else float((1.0 - c).max())


def worst_ray_angle(j2d: torch.Tensor, want: torch.Tensor, intr: torch.Tensor) -> float:
    """The largest angle, in radians, between the lines of sight through a
    joint's 2D point and the reference's, (B, V, N, 2) each with the
    cameras' intrinsics (B, V, 3, 3); in float64, NaN where either holds a
    NaN. A line of sight stays well defined where the projection's division
    by a depth near zero sends the point itself far off."""
    k = intr.double()[:, :, None]

    def ray(p):
        p = p.double()
        return torch.stack([(p[..., 0] - k[..., 0, 2]) / k[..., 0, 0],
                            (p[..., 1] - k[..., 1, 2]) / k[..., 1, 1], torch.ones_like(p[..., 0])], -1)
    a, b = ray(j2d), ray(want)
    ang = torch.atan2(torch.linalg.vector_norm(torch.cross(a, b, dim=-1), dim=-1),
                      (a * b).sum(-1).abs())
    return float("nan") if ang.isnan().any() else float(ang.max())


def worst(a: float, b: float) -> float:
    """The larger of two readings, NaN once either is NaN."""
    return b if (b != b or b > a) else a
