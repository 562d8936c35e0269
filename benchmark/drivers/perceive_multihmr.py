"""Offline two-view perception with Multi-HMR: one caller runs
``perception.perceive_multihmr`` back to back on batches of whole two-view
frames, cycling through a pool of distinct batches that stay on the device.

The pool: each frame RGB uint8 (a smooth random field plus pixel noise at a
random brightness and contrast, like ``inputs.perception_pool``'s crops),
cast and normalised at the call; each image's persons drawn on the host
(``person_layout``): their number geometric with mean ``persons_mean``,
redrawn above ``persons_max``, each at a distinct patch of the grid plus a
uniform sub-patch offset, given to the call as centres, as the drone's
tracker would give them; both drone cameras' intrinsics as ``intrinsics``
gives them. Set-up builds Multi-HMR from the seed's weights
(``reference/multihmr.py``'s maker), the synthetic SMPL-X model with its
expression directions and the pool, and warms up with two calls. The
window's rate counts every two-view frame of every call over the window,
which ends in a ``synchronize``. A reservoir drawn from the seed keeps the
outputs of ``sampled_calls`` calls of the window (the backbone's tokens and
the call's persons).

The check judges the stages of a call by themselves. The backbone: the
plain float32 reference over the same frames, one frame at a time, against
the program's tokens, each frame's tokens by the direction of their
departure from the call's mean frame and the call's tokens by their
relative L2 distance. The persons: their number and (frame, view) exactly
as the traffic gave them. What follows the backbone (detection's score
map, the head, SMPL-X with hands, jaw and expression, the translation and
the projection): the reference's float32 tail on the program's own tokens
at the traffic's centres, against the program's score map, each person's
body-frame vertices (the worst person), translation and 2D joints (lines
of sight). With ``ctx.control`` (``int8``) the reference stands in for the
program one precision lower: the backbone's linears on int8-quantized
operands, the tail in bfloat16. ``ctx.fault`` plants a fault in the
program: ``skip_block`` drops the backbone's last block, ``gamma_one``
sets every LayerScale γ to 1, ``swap_images`` swaps the first frame's two
views inside each call, ``move_centre`` moves the call's first
person's centre one patch to the right, ``unmask_padding`` lets every
query slot of the head's self-attention see the padded slots, and
``mean_hands`` leaves the hands at the model's mean pose.
"""

import dataclasses
import random
import time
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch
from torch.nn import functional as F

from ..harness import Check, Window, sync
from ..inputs import FOCAL, IMAGE_SIZE
from ..reference import multihmr as ref
from ..reference.model import no_tf32
from . import (no_init_draw, program_body, rel_l2, worst, worst_ray_angle, worst_row_cos_gap,
               worst_row_rel_l2)

LEVELS = {"int8": 127}


@dataclasses.dataclass
class State:
    model: object
    body: object
    pool: List[Dict]
    fault: Optional[str] = None
    calls: int = 0
    seen: dict = dataclasses.field(default_factory=dict)
    kept: list = dataclasses.field(default_factory=list)


def intrinsics(size: int, device) -> torch.Tensor:
    """The synthetic drone camera's middle 1,080² resized to ``size``²: its
    focal length scaled, the principal point at the frame's centre."""
    f = FOCAL[0] * size / IMAGE_SIZE[1]
    return torch.tensor([[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]], device=device)


def person_layout(seed: int, batches: int, images: int, grid: int, mean: float,
                  most: int) -> List[List[np.ndarray]]:
    """For each batch and image, its persons' (patch, u offset, v offset),
    drawn on the host: the number geometric on 0, 1, ... with ``mean``,
    redrawn above ``most``; distinct patches; offsets uniform in the middle
    98% of a patch (fractions of it), so that no centre rounds into the next
    patch."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (1.0 + mean)
    out = []
    for _ in range(batches):
        batch = []
        for _ in range(images):
            k = int(rng.geometric(p)) - 1
            while k > most:
                k = int(rng.geometric(p)) - 1
            patch = rng.choice(grid * grid, size=k, replace=False)
            batch.append(np.concatenate([patch[:, None], 0.01 + 0.98 * rng.random((k, 2))], axis=1))
        out.append(batch)
    return out


def person_counts(ctx) -> List[List[int]]:
    """Persons an image, for each batch of the pool (``person_layout``'s
    numbers, without the pool)."""
    s, g = ctx.sizes, ctx.cfg["backbone"]["grid"]
    return [[len(a) for a in b] for b in person_layout(
        ctx.seed_of(6), s["pool_batches"], s["batch"] * ctx.cfg["views"], g,
        s["persons_mean"], s["persons_max"])]


def multihmr_pool(ctx, device) -> List[Dict]:
    """The pool's batches: frames (B, 2, S, S, 3) uint8, intr (B, 2, 3, 3),
    the persons' centres (P, 2), images (P,), patches (P,) and ``Persons``."""
    from airpose_tpu_torch.models.multihmr import persons_from_centres

    s, cfg = ctx.sizes, ctx.cfg
    B, views, S = s["batch"], cfg["views"], s["crop"]
    p, g = cfg["backbone"]["patch"], cfg["backbone"]["grid"]
    layout = person_layout(ctx.seed_of(6), s["pool_batches"], B * views, g,
                           s["persons_mean"], s["persons_max"])
    gen = torch.Generator(device=device).manual_seed(ctx.seed_of(3))
    K = intrinsics(S, device).expand(B, views, 3, 3)
    pool = []
    for lay in layout:
        coarse = torch.randn((B * views, 3, 7, 7), generator=gen, device=device)
        x = F.interpolate(coarse, size=(S, S), mode="bilinear", align_corners=False)
        x = x.permute(0, 2, 3, 1).reshape(B, views, S, S, 3)
        x += 0.5 * torch.randn(x.shape, generator=gen, device=device)
        x *= 0.5 + torch.rand((B, views, 1, 1, 1), generator=gen, device=device)
        x += torch.randn((B, views, 1, 1, 3), generator=gen, device=device)
        frames = (128.0 + 48.0 * x).round_().clamp_(0, 255).to(torch.uint8)
        del coarse, x
        rows = np.concatenate([np.concatenate([np.full((len(a), 1), i), a], axis=1)
                               for i, a in enumerate(lay)])
        image = torch.as_tensor(rows[:, 0], dtype=torch.int64, device=device)
        patch = torch.as_tensor(rows[:, 1], dtype=torch.int64, device=device)
        uv = torch.as_tensor(np.stack([rows[:, 1] % g + rows[:, 2], rows[:, 1] // g + rows[:, 3]],
                                      axis=1) * p, dtype=torch.float32, device=device)
        slots = max(len(a) for a in lay)
        pool.append({"frames": frames, "intr": K, "uv": uv, "image": image, "patch": patch,
                     "persons": persons_from_centres(uv, image, B * views, p, g, slots)})
        if ctx.fault == "move_centre" and len(rows):
            moved = uv.clone()
            moved[0, 0] = (moved[0, 0] + p) if rows[0, 1] % g < g - 1 else (moved[0, 0] - p)
            pool[-1]["moved"] = persons_from_centres(moved, image, B * views, p, g, slots)
        elif ctx.fault == "move_centre":
            pool[-1]["moved"] = pool[-1]["persons"]
    return pool


def program_multihmr(cfg, state: dict, device):
    """The program's Multi-HMR at the configuration's sizes with ``state``
    loaded strictly (its own draw skipped)."""
    from airpose_tpu_torch.models.multihmr import MultiHMR, MultiHMRConfig
    from airpose_tpu_torch.models.vit import ViTConfig

    vb, hd, ce = cfg["backbone"], cfg["head"], cfg["camera_embedding"]
    vit = ViTConfig(img_size=tuple(vb["img_size"]), patch=vb["patch"], width=vb["width"],
                    depth=vb["depth"], heads=vb["heads"], mlp_ratio=vb["mlp_ratio"],
                    padding=vb["padding"], dinov2_grid=vb["pos_grid"])
    mc = MultiHMRConfig(vit=vit, head_dim=hd["dim"], xat_depth=hd["xat_depth"],
                        xat_heads=hd["heads"], xat_dim_head=hd["dim_head"],
                        xat_mlp_dim=hd["mlp_dim"], bands=ce["bands"],
                        max_resolution=ce["max_resolution"],
                        threshold=cfg["detection"]["threshold"])
    with no_init_draw():
        model = MultiHMR(dtype=getattr(torch, cfg["backbone_dtype"]), cfg=mc)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


def unmasked(model) -> None:
    """Plant ``unmask_padding``: the head's self-attention runs without its
    mask, so every query slot, real or padded, sees every slot of its
    image."""
    head = model.x_attention_head.transformer
    forward = head.forward
    head.forward = lambda x, context, mask=None: forward(x, context, None)


def setup(ctx) -> State:
    s, dev = ctx.sizes, ctx.device
    ctx.phase("imports")
    weights = ref.make_state(ctx.cfg, ctx.seed_of(1), dev)
    ctx.phase("weights")
    model = program_multihmr(ctx.cfg, weights, dev)
    del weights
    if ctx.fault == "skip_block":
        del model.backbone.encoder.blocks[-1]
    if ctx.fault == "gamma_one":
        with torch.no_grad():
            for blk in model.backbone.encoder.blocks:
                blk.ls1.gamma.fill_(1.0)
                blk.ls2.gamma.fill_(1.0)
    if ctx.fault == "unmask_padding":
        unmasked(model)
    ctx.phase("model")
    body = program_body(ref.make_body(ctx.seed_of(2), s["num_vertices"], dev))
    pool = multihmr_pool(ctx, dev)
    ctx.phase("body_and_inputs")
    st = State(model, body, pool, fault=ctx.fault)
    st.model.backbone.register_forward_hook(lambda m, args, out: st.seen.update(tokens=out))
    for _ in range(2):
        call(st)
    st.calls = 0
    return st


def call(st: State):
    """One perception call on the next batch of the pool → (pool index,
    tokens, the call's ``PerceivedPersons``)."""
    from airpose_tpu_torch import perception

    i = st.calls % len(st.pool)
    b = st.pool[i]
    frames, persons = b["frames"], b["persons"]
    if st.fault == "swap_images":
        frames = frames.clone()
        frames[0, [0, 1]] = frames[0, [1, 0]]
    if st.fault == "move_centre":
        persons = b["moved"]
    if st.fault == "mean_hands":
        forward = perception.smplx_forward

        def without_hands(*a, hand_pose=None, **k):
            return forward(*a, **k)
        with mock.patch.object(perception, "smplx_forward", without_hands):
            out = perception.perceive_multihmr(st.model, st.body, frames, b["intr"], persons)
    else:
        out = perception.perceive_multihmr(st.model, st.body, frames, b["intr"], persons)
    st.calls += 1
    return i, st.seen.pop("tokens"), out


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
    bad = sum(ctx.sizes["batch"] for _, t, o in st.kept
              if not all(bool(torch.isfinite(x).all()) for x in (o.vertices, o.j2d, o.scores)))
    return Window({"two_view_fps": frames / elapsed}, attempted=frames, failed=bad,
                  seconds=elapsed, units=n)


def unit(ctx, st: State) -> None:
    call(st)


def evidence(ctx, st: State) -> dict:
    """The sampled calls' inputs and outputs; the program's model and pool go."""
    keep = ("frames", "intr", "image", "patch")
    return {"kept": [({k: st.pool[i][k] for k in keep}, t, o) for i, t, o in st.kept]}


@torch.no_grad()
def check(ctx, ev: dict) -> List[Check]:
    """The plain float32 reference over each sampled call's inputs: its
    backbone against the program's tokens (direction and size), the persons
    against the traffic's, its tail on the program's tokens at the
    traffic's centres against the program's score map, vertices,
    translations and 2D joints."""
    no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = ref.make_state(cfg, ctx.seed_of(1), dev)
    body = ref.make_body(ctx.seed_of(2), s["num_vertices"], dev)
    tok = tok_rel = mismatch = verts = trans = joints = score = 0.0
    for b, t, o in ev["kept"]:
        B, views = b["frames"].shape[:2]
        x = b["frames"].reshape((B * views,) + b["frames"].shape[2:])
        K = b["intr"].reshape(B * views, 3, 3)
        rt = torch.cat([ref.backbone(sd, cfg, x[n:n + 1]) for n in range(x.shape[0])])
        want = torch.stack([b["image"] // views, b["image"] % views], dim=-1)
        same = o.index.shape == want.shape and torch.equal(o.index, want)
        mismatch = max(mismatch, 0.0 if same else float(
            abs(o.index.shape[0] - want.shape[0]) + (o.index[:len(want)] != want[:len(o.index)]
                                                     ).any(-1).sum()))
        v, j, tr, sc = o.vertices - o.trans[:, None], o.j2d, o.trans, o.scores.reshape(
            B * views, *o.scores.shape[2:])
        if ctx.control:
            t = torch.cat([ref.backbone(sd, cfg, x[n:n + 1], LEVELS[ctx.control])
                           for n in range(x.shape[0])])
            v, j, tr, sc = ref.perceive_tail(sd, cfg, body, t, K, b["image"], b["patch"],
                                             torch.bfloat16)
        # tokens of random weights share much of their norm across frames, and a
        # swapped frame differs from the right one only in its departure from
        # the call's mean frame: compare the directions of the departures
        m = rt.mean(0)
        tok = worst(tok, worst_row_cos_gap(t - m, rt - m))
        tok_rel = worst(tok_rel, rel_l2(t, rt))
        tv, tj, ttr, tsc = ref.perceive_tail(sd, cfg, body, t.float(), K, b["image"], b["patch"])
        score = worst(score, rel_l2(sc, tsc))
        if not len(tv) or v.shape != tv.shape:
            continue   # no person in the call, or a person lost (``persons_index_mismatch``)
        verts = worst(verts, worst_row_rel_l2(v, tv, 1))
        trans = worst(trans, worst_row_rel_l2(tr, ttr, 1))
        joints = worst(joints, worst_ray_angle(j[:, None], tj[:, None],
                                               K[b["image"]][:, None]))
    lim = ctx.cell.workload["limits"]
    return [Check("tokens_cos_gap", tok, lim.get("tokens_cos_gap")),
            Check("tokens_call_rel", tok_rel, lim.get("tokens_call_rel")),
            Check("persons_index_mismatch", mismatch, lim.get("persons_index_mismatch")),
            Check("tail_vertices_rel", verts, lim.get("tail_vertices_rel")),
            Check("trans_rel", trans, lim.get("trans_rel")),
            Check("joints2d_ray_angle", joints, lim.get("joints2d_ray_angle")),
            Check("scores_rel", score, lim.get("scores_rel"))]
