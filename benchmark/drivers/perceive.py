"""Offline two-view perception: one caller runs ``perception.perceive``
back to back on batches of two-view frames, cycling through a pool of
distinct batches that stay on the device.

Set-up builds AirPoseTwoView from the seed's weights, the synthetic SMPL-X
model and the input pool, prepares the trunk with ``chain_ops`` (the int8
trunk quantizes the folded weights and calibrates its activation scales on
the first frame's two crops) and warms up with two calls. The window's
rate counts every frame of every call over the window, which ends in a
``synchronize``. A reservoir drawn from the seed keeps the outputs of
``sampled_calls`` calls of the window (features, vertices, 2D joints).

The check judges the two stages of a call by themselves. The trunk: the
plain reference's int8 trunk, quantized and calibrated from the raw
weights, over the same crops, against the program's features. What
follows the trunk (IEF, SMPL-X with its skinning, the projection): the
reference's float32 tail run on the program's own features, against the
program's vertices and 2D joints. The tail alone is judged from the
program's features because random weights make a few bodies' poses so
sensitive that the trunk's rounding, carried through, moves a body by
half its size on some seeds. The 2D joints are judged as lines of sight,
which stay well defined for a joint near the camera's plane.
"""

import dataclasses
import random
import time
from typing import Dict, List

import torch

from ..harness import Check, Window, sync
from ..inputs import perception_pool
from ..reference import model as ref
from ..reference.int8 import Int8Trunk
from ..reference.weights import make_smplx, make_state
from . import (program_body, program_model, rel_l2, worst, worst_ray_angle, worst_row_cos_gap,
               worst_row_rel_l2)

LEVELS = {"int8": 127, "int4": 7}


@dataclasses.dataclass
class State:
    model: object
    body: object
    features: object
    pool: List[Dict[str, torch.Tensor]]
    calls: int = 0
    kept: list = dataclasses.field(default_factory=list)


def setup(ctx) -> State:
    from airpose_tpu_torch.models.airpose import AirPoseTwoView
    from airpose_tpu_torch.perception import chain_ops

    s, dev = ctx.sizes, ctx.device
    ctx.phase("imports")
    weights = make_state(ctx.cfg, ctx.seed_of(1), dev)
    ctx.phase("weights")
    model = program_model(AirPoseTwoView, weights, dev)
    ctx.phase("model")
    body = program_body(make_smplx(ctx.seed_of(2), s["num_vertices"], dev))
    pool = perception_pool(ctx.seed_of(3), s["pool_batches"], s["batch"], s["crop"], dev)
    ctx.phase("body_and_inputs")
    features = chain_ops(model, s["trunk"], pool[0]["images"][0])
    ctx.phase("quantize_and_calibrate")
    st = State(model, body, features, pool)
    for _ in range(2):
        call(st)
    st.calls = 0
    return st


def call(st: State):
    """One perception call on the next batch of the pool → (pool index,
    features, vertices, 2D joints)."""
    from airpose_tpu_torch.perception import perceive

    i = st.calls % len(st.pool)
    b = st.pool[i]
    seen = {}

    def features(x, use_kernels=True):
        seen["f"] = st.features(x, use_kernels=use_kernels)
        return seen["f"]

    verts, j2d = perceive(st.model, st.body, b["images"], b["bb"], b["init_position"],
                          b["intr"], features)
    st.calls += 1
    return i, seen["f"], verts, j2d


def window(ctx, st: State, seconds: float) -> Window:
    k = ctx.sizes["sampled_calls"]
    rng = random.Random(ctx.seed_of(5))
    sync(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        out = call(st)
        if n < k:
            st.kept.append(out)
        else:
            j = rng.randrange(n + 1)
            if j < k:
                st.kept[j] = out
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(ctx.device)
    elapsed = time.perf_counter() - t0
    frames = n * ctx.sizes["batch"]
    bad = sum(ctx.sizes["batch"] for _, f, v, j in st.kept
              if not (torch.isfinite(v).all() and torch.isfinite(j).all()))
    return Window({"two_view_fps": frames / elapsed}, attempted=frames, failed=bad,
                  seconds=elapsed, units=n)


def unit(ctx, st: State) -> None:
    call(st)


def evidence(ctx, st: State) -> dict:
    """The sampled calls' inputs and outputs and the calibration crops; the
    program's model, trunk and pool go."""
    scales = getattr(st.features, "keywords", {}).get("act_scales")
    return {"calib": st.pool[0]["images"][0], "program_scales": scales,
            "kept": [(st.pool[i], f, v, j) for i, f, v, j in st.kept]}


@torch.no_grad()
def check(ctx, ev: dict) -> List[Check]:
    """The plain reference over each sampled call's inputs: the int8 trunk
    (quantized, calibrated and run from the raw weights) against the
    program's features; the float32 tail on the program's features against
    its vertices and 2D joints. With ``ctx.control`` (``int4``) the
    reference stands in for the program at the next lower precisions: the
    trunk at int4, the tail in bfloat16."""
    ref.no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = make_state(cfg, ctx.seed_of(1), dev)
    body = make_smplx(ctx.seed_of(2), s["num_vertices"], dev)

    calibrated = {}

    def reference_trunk(levels):
        trunk = Int8Trunk(sd, cfg["trunk"], levels)
        scales = trunk.calibrate(ev["calib"])
        calibrated[levels] = scales

        def features(b):
            B = b["images"].shape[0]
            return trunk(b["images"].reshape((B * 2,) + b["images"].shape[2:]), scales)
        return features

    def tail(xf, b, dtype=torch.float32):
        B = b["images"].shape[0]
        return ref.perceive_tail(sd, cfg, body, xf.reshape(B, 2, -1), b["bb"],
                                 b["init_position"], b["intr"], dtype)

    want = reference_trunk(LEVELS[s["trunk"]])
    stand_in = reference_trunk(LEVELS[ctx.control]) if ctx.control else None
    feat = verts = joints = 0.0   # the worst crop, body and joint
    detail = {"features_call_rel": 0.0, "vertices_rel_through_reference_trunk": 0.0}
    prog = ev["program_scales"]
    if prog:
        mine = {k: float(v) for k, v in calibrated[LEVELS[s["trunk"]]].items()}
        differ = [k for k in mine if prog.get(k) != mine[k]]
        detail["scales_differ"] = len(differ)
        detail["scale_rel_max"] = max((abs(prog[k] - mine[k]) / mine[k] for k in differ),
                                      default=0.0)
    for b, f, v, j in ev["kept"]:
        rf = want(b)
        if stand_in is not None:
            f = stand_in(b)
            v, j = tail(f, b, torch.bfloat16)
        f = f.reshape(rf.shape)
        # features of random weights share most of their norm across crops, and a
        # swapped or stale crop differs from the right one only in its departure
        # from the call's mean crop: compare the directions of the departures
        m = rf.mean(0)
        feat = worst(feat, worst_row_cos_gap(f - m, rf - m))
        tv, tj = tail(f, b)
        verts = worst(verts, worst_row_rel_l2(v, tv, 2))
        joints = worst(joints, worst_ray_angle(j, tj, b["intr"]))
        detail["features_call_rel"] = worst(detail["features_call_rel"], rel_l2(f, rf))
        detail["vertices_rel_through_reference_trunk"] = worst(
            detail["vertices_rel_through_reference_trunk"], worst_row_rel_l2(v, tail(rf, b)[0], 2))
    lim = ctx.cell.workload["limits"]
    return [Check("features_cos_gap", feat, lim.get("features_cos_gap"), detail),
            Check("tail_vertices_rel", verts, lim.get("tail_vertices_rel")),
            Check("joints2d_ray_angle", joints, lim.get("joints2d_ray_angle"))]
