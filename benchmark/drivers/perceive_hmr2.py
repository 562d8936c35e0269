"""Offline two-view perception with HMR 2.0: one caller runs
``perception.perceive_hmr2`` back to back on batches of two-view frames,
cycling through a pool of distinct batches that stay on the device.

Set-up builds HMR2 from the seed's weights (``reference/hmr2.py``'s maker),
the synthetic SMPL model and the input pool of 256² crops, and warms up
with two calls. The window's rate counts every frame of every call over the
window, which ends in a ``synchronize``. A reservoir drawn from the seed
keeps the outputs of ``sampled_calls`` calls of the window (the backbone's
tokens, vertices, 2D joints).

The check judges the two stages of a call by themselves. The backbone: the
plain float32 reference over the same crops against the program's tokens,
each crop's tokens compared by the direction of their departure from the
call's mean crop, and the call's tokens as a whole by their relative L2
distance, which sees a change of size that keeps the directions. What follows the backbone (the decoder, 6D → rotations,
SMPL with its skinning, the crop camera's translation, the projection): the
reference's float32 tail on the program's own tokens, against the
program's vertices (the worst body, relative L2) and 2D joints (lines of
sight). With ``ctx.control`` (``int8``) the reference stands in for the
program one precision lower: the backbone's linears on int8-quantized
operands, the tail in bfloat16. ``ctx.fault`` plants a fault in the
program: ``skip_block`` drops the backbone's last block, ``swap_crops``
swaps the first two frames' view-0 crops inside each call, ``scale_tokens``
scales the backbone's last LayerNorm by 1.05, so that every token keeps its
direction and grows by a twentieth.
"""

import dataclasses
import random
import time
from typing import Dict, List

import torch

from ..harness import Check, Window, sync
from ..inputs import perception_pool
from ..reference import hmr2 as ref
from ..reference.model import no_tf32
from . import no_init_draw, worst, worst_ray_angle, worst_row_cos_gap, worst_row_rel_l2

LEVELS = {"int8": 127}


@dataclasses.dataclass
class State:
    model: object
    body: object
    pool: List[Dict[str, torch.Tensor]]
    swap: bool = False
    calls: int = 0
    seen: dict = dataclasses.field(default_factory=dict)
    kept: list = dataclasses.field(default_factory=list)


def program_hmr2(cfg, state: dict, device):
    """The program's HMR2 at the configuration's sizes with ``state`` loaded
    strictly (its own draw skipped)."""
    from airpose_tpu_torch.models.hmr2 import HMR2, DecoderConfig
    from airpose_tpu_torch.models.vit import ViTConfig

    vb, hd = cfg["backbone"], cfg["head"]
    vit = ViTConfig(img_size=tuple(vb["img_size"]), patch=vb["patch"], width=vb["width"],
                    depth=vb["depth"], heads=vb["heads"], mlp_ratio=vb["mlp_ratio"],
                    padding=vb["padding"])
    dec = DecoderConfig(dim=hd["dim"], depth=hd["depth"], heads=hd["heads"],
                        dim_head=hd["dim_head"], mlp_dim=hd["mlp_dim"],
                        context_dim=hd["context_dim"])
    with no_init_draw():
        model = HMR2(dtype=getattr(torch, cfg["backbone_dtype"]), vit=vit, decoder=dec)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def program_smpl(body: dict):
    from airpose_tpu_torch.bodymodel.smpl import SMPLParams

    return SMPLParams(**body)


def setup(ctx) -> State:
    s, dev = ctx.sizes, ctx.device
    ctx.phase("imports")
    weights = ref.make_state(ctx.cfg, ctx.seed_of(1), dev)
    ctx.phase("weights")
    model = program_hmr2(ctx.cfg, weights, dev)
    del weights
    if ctx.fault == "skip_block":
        del model.backbone.blocks[-1]
    if ctx.fault == "scale_tokens":
        with torch.no_grad():
            for p in model.backbone.last_norm.parameters():
                p.mul_(1.05)
    ctx.phase("model")
    body = program_smpl(ref.make_smpl(ctx.seed_of(2), s["num_vertices"], dev))
    pool = perception_pool(ctx.seed_of(3), s["pool_batches"], s["batch"], s["crop"], dev)
    ctx.phase("body_and_inputs")
    st = State(model, body, pool, swap=ctx.fault == "swap_crops")
    st.model.backbone.register_forward_hook(lambda m, args, out: st.seen.update(tokens=out))
    for _ in range(2):
        call(st)
    st.calls = 0
    return st


def call(st: State):
    """One perception call on the next batch of the pool → (pool index,
    tokens, vertices, 2D joints)."""
    from airpose_tpu_torch.perception import perceive_hmr2

    i = st.calls % len(st.pool)
    b = st.pool[i]
    images = b["images"]
    if st.swap:
        images = images.clone()
        images[[0, 1], 0] = images[[1, 0], 0]
    verts, j2d = perceive_hmr2(st.model, st.body, images, b["bb"], b["intr"])
    st.calls += 1
    return i, st.seen.pop("tokens"), verts, j2d


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
    bad = sum(ctx.sizes["batch"] for _, t, v, j in st.kept
              if not (torch.isfinite(v).all() and torch.isfinite(j).all()))
    return Window({"two_view_fps": frames / elapsed}, attempted=frames, failed=bad,
                  seconds=elapsed, units=n)


def unit(ctx, st: State) -> None:
    call(st)


def evidence(ctx, st: State) -> dict:
    """The sampled calls' inputs and outputs; the program's model and pool go."""
    return {"kept": [(st.pool[i], t, v, j) for i, t, v, j in st.kept]}


@torch.no_grad()
def check(ctx, ev: dict) -> List[Check]:
    """The plain float32 reference over each sampled call's inputs: its
    backbone against the program's tokens (direction and size), its tail on
    the program's tokens against the program's vertices and 2D joints."""
    no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = ref.make_state(cfg, ctx.seed_of(1), dev)
    body = ref.make_smpl(ctx.seed_of(2), s["num_vertices"], dev)
    crop = s["crop"]
    tok = tok_rel = verts = joints = 0.0   # the worst crop, call, body and joint
    for b, t, v, j in ev["kept"]:
        B = b["images"].shape[0]
        x = b["images"].reshape((B * 2,) + b["images"].shape[2:])
        rt = ref.backbone(sd, cfg, x)
        tail_dtype = torch.float32
        if ctx.control:
            t = ref.backbone(sd, cfg, x, LEVELS[ctx.control])
            tail_dtype = torch.bfloat16
            v, j = ref.perceive_tail(sd, cfg, body, t.reshape(B, 2, *t.shape[1:]), b["bb"],
                                     b["intr"], crop, tail_dtype)
        # tokens of random weights share much of their norm across crops, and a
        # swapped crop differs from the right one only in its departure from
        # the call's mean crop: compare the directions of the departures
        m = rt.mean(0)
        tok = worst(tok, worst_row_cos_gap(t - m, rt - m))
        tok_rel = worst(tok_rel, float((t - rt).norm() / rt.norm()))
        tv, tj = ref.perceive_tail(sd, cfg, body, t.reshape(B, 2, *t.shape[1:]).float(),
                                   b["bb"], b["intr"], crop)
        verts = worst(verts, worst_row_rel_l2(v, tv, 2))
        joints = worst(joints, worst_ray_angle(j, tj, b["intr"]))
    lim = ctx.cell.workload["limits"]
    return [Check("tokens_cos_gap", tok, lim.get("tokens_cos_gap")),
            Check("tokens_call_rel", tok_rel, lim.get("tokens_call_rel")),
            Check("tail_vertices_rel", verts, lim.get("tail_vertices_rel")),
            Check("joints2d_ray_angle", joints, lim.get("joints2d_ray_angle"))]
