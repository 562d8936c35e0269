"""Offline two-view perception on the port's default trunk: the ``perceive``
driver's set-up, window, traced step and evidence with
``chain_ops(model, "bf16")`` (the stem, the fused layer1 kernel, layers 2-4
on cuDNN), and a check of its own.

The check judges the two stages of a call by themselves, as ``perceive``'s
does. The trunk: the plain reference's bf16 trunk (``reference.model.trunk``
in eval mode, from the raw weights) over the same crops, against the
program's features, by the direction of each crop's departure from the
call's mean crop. What follows the trunk: the reference's float32 tail on
the program's own features, against its vertices and 2D joints. With
``ctx.control`` (``int8``) the reference's int8 trunk, quantized and
calibrated from the raw weights, and its tail in bfloat16 stand in for the
program: the next lower precisions.
"""

from typing import List

import torch

from ..harness import Check
from ..reference import model as ref
from ..reference.int8 import Int8Trunk
from ..reference.weights import make_smplx, make_state
from . import rel_l2, worst, worst_ray_angle, worst_row_cos_gap, worst_row_rel_l2
from .perceive import call, evidence, setup, unit, window  # noqa: F401

LEVELS = {"int8": 127}


@torch.no_grad()
def check(ctx, ev: dict) -> List[Check]:
    ref.no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = make_state(cfg, ctx.seed_of(1), dev)
    body = make_smplx(ctx.seed_of(2), s["num_vertices"], dev)

    def folded(b):
        B = b["images"].shape[0]
        return b["images"].reshape((B * 2,) + b["images"].shape[2:])

    def tail(xf, b, dtype=torch.float32):
        B = b["images"].shape[0]
        return ref.perceive_tail(sd, cfg, body, xf.reshape(B, 2, -1), b["bb"],
                                 b["init_position"], b["intr"], dtype)

    stand_in = None
    if ctx.control:
        trunk = Int8Trunk(sd, cfg["trunk"], LEVELS[ctx.control])
        scales = trunk.calibrate(ev["calib"])

        def stand_in(b):
            return trunk(folded(b), scales)
    feat = verts = joints = 0.0   # the worst crop, body and joint
    detail = {"features_call_rel": 0.0}
    for b, f, v, j in ev["kept"]:
        rf = ref.trunk(sd, cfg["trunk"], folded(b), torch.bfloat16, train=False)
        if stand_in is not None:
            f = stand_in(b)
            v, j = tail(f, b, torch.bfloat16)
        f = f.reshape(rf.shape)
        # features of random weights share most of their norm across crops:
        # compare the directions of the departures from the call's mean crop
        m = rf.mean(0)
        feat = worst(feat, worst_row_cos_gap(f - m, rf - m))
        tv, tj = tail(f, b)
        verts = worst(verts, worst_row_rel_l2(v, tv, 2))
        joints = worst(joints, worst_ray_angle(j, tj, b["intr"]))
        detail["features_call_rel"] = worst(detail["features_call_rel"], rel_l2(f, rf))
    lim = ctx.cell.workload["limits"]
    return [Check("features_cos_gap", feat, lim.get("features_cos_gap"), detail),
            Check("tail_vertices_rel", verts, lim.get("tail_vertices_rel")),
            Check("joints2d_ray_angle", joints, lim.get("joints2d_ray_angle"))]
