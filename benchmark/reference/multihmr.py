"""Plain Multi-HMR (Baradel et al., ECCV 2024, arXiv:2402.14654;
github.com/naver/multi-hmr, ``multiHMR_896_L``): DINOv2's ViT-L/14 over
whole frames, the camera embedding, detection, the Human Prediction Head
one image at a time over that image's persons, whole-body SMPL-X and the
projection, over a state dict in the program's layout; float32 with TF32
off.

* Backbone (DINOv2, Oquab et al., arXiv:2304.07193): the frame's RGB 0-255
  normalised with ImageNet's mean and deviation, a patch convolution
  (stride = kernel = 14, no padding), the CLS token first, the stored
  ``pos_grid``² position embedding bicubically resized to the patch grid
  (DINOv2 passes the scale factor (grid + 0.1) / pos_grid instead of the
  size, which moves its sample points by a fraction of a patch), ``depth``
  pre-norm blocks x += γ₁ ⊙ Attn(LN(x)), x += γ₂ ⊙ MLP(LN(x)) of explicit
  softmax(QKᵀ/√d)V attention (biased qkv) and an exact-GELU MLP, LayerNorm
  eps 1e-6, the last LayerNorm. With ``levels`` (the control) every linear
  of the blocks takes int8-style operands (``reference/hmr2.py``'s).
* Camera embedding: each token's ray d = normalise(K⁻¹[u, v, 1]) at its
  patch centre (the frame's centre for the CLS token), as [d, sin(π f d),
  cos(π f d)] for ``bands`` frequencies f = linspace(1, max_resolution / 2),
  after the token.
* Detection: a 1,024 → 1,024 → 1 ReLU MLP on each patch token, sigmoid;
  the persons' sub-patch offsets from a 1,024 → 1,024 → 2 MLP, sigmoid,
  centre = (col + σ, row + σ) · patch. (NMS and the threshold are not
  needed here: the cell gives the persons' centres.)
* Head: per image, one query a person (the embedded context token at its
  patch plus the embedded mean parameters), ``xat_depth`` pre-norm layers
  of self-attention among that image's persons only, cross-attention into
  its tokens (no bias on q, k, v; LayerNorm eps 1e-5) and a GELU MLP; the
  readouts added to the mean parameters; depth = exp(log-depth).
* SMPL-X with the regressed root, 21 body joints, jaw and 30 hand joints
  (eyes at the identity) and 10 expression coefficients whose directions
  add to the shape's; the 127 joints as ``reference/smplx.py`` gives them.
  The translation depth · K⁻¹[u, v, 1]; the joints projected with K.

The published head's query construction, depth parametrisation, band count
and sizes are not public in detail: what this file computes is the
configuration's ``assumed`` list, the same as the program's.
"""

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

from .hmr2 import _attend, _fan_in, _lin, _linear, _norm
from .smplx import SMPLX_PARENTS, _levels, rot6d_to_rotmat
from .weights import make_smplx

Tensor = torch.Tensor
Spec = List[Tuple[str, Tuple[int, ...], str]]

IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
NUM_POSE_JOINTS = 53


# ---- the state dict ------------------------------------------------------------------

def model_spec(cfg: Mapping) -> Spec:
    """Every tensor of the program's Multi-HMR state dict, with its shape and
    the kind of draw that fills it."""
    vb, hd, dt = cfg["backbone"], cfg["head"], cfg["detection"]
    C, p = vb["width"], vb["patch"]
    e = "backbone.encoder."
    spec = [(e + "cls_token", (1, 1, C), "vit_w"),
            (e + "pos_embed", (1, vb["pos_grid"] ** 2 + 1, C), "vit_w"),
            (e + "patch_embed.proj.weight", (C, 3, p, p), "uniform"),
            (e + "patch_embed.proj.bias", (C,), "uniform")]
    for i in range(vb["depth"]):
        b = f"{e}blocks.{i}."
        spec += _norm(b + "norm1", C) + _linear(b + "attn.qkv", C, 3 * C, "vit_w")
        spec += _linear(b + "attn.proj", C, C, "vit_w") + _norm(b + "norm2", C)
        spec += _linear(b + "mlp.fc1", C, vb["mlp_ratio"] * C, "vit_w")
        spec += _linear(b + "mlp.fc2", vb["mlp_ratio"] * C, C, "vit_w")
        spec += [(b + "ls1.gamma", (C,), "gamma"), (b + "ls2.gamma", (C,), "gamma")]
    spec += _norm(e + "last_norm", C)
    for name, out in (("mlp_classif", 1), ("mlp_offset", 2)):
        spec += _linear(f"{name}.0", C, dt["hidden"], "uniform")
        spec += _linear(f"{name}.2", dt["hidden"], out, "uniform")
    D, inner, ctx = hd["dim"], hd["heads"] * hd["dim_head"], hd["context_dim"]
    n_params = sum(cfg["outputs"][k] for k in ("decpose", "decshape", "decexpression"))
    h = "x_attention_head."
    spec += _linear(h + "to_token_embedding", ctx, D, "uniform")
    spec += _linear(h + "embed_init", n_params, D, "uniform")
    for i in range(hd["xat_depth"]):
        L = f"{h}transformer.layers.{i}."
        spec += _norm(L + "0.norm", D) + _linear(L + "0.fn.to_qkv", D, 3 * inner, "uniform", False)
        spec += _linear(L + "0.fn.to_out.0", inner, D, "uniform")
        spec += _norm(L + "1.norm", D)
        spec += _linear(L + "1.fn.to_kv", ctx, 2 * inner, "uniform", False)
        spec += _linear(L + "1.fn.to_q", D, inner, "uniform", False)
        spec += _linear(L + "1.fn.to_out.0", inner, D, "uniform")
        spec += _norm(L + "2.norm", D) + _linear(L + "2.fn.net.0", D, hd["mlp_dim"], "uniform")
        spec += _linear(L + "2.fn.net.3", hd["mlp_dim"], D, "uniform")
    for name, dim in cfg["outputs"].items():
        spec += _linear(h + name, D, dim, "uniform")
    spec += [(h + "init_body_pose", (1, cfg["outputs"]["decpose"]), "init_pose"),
             (h + "init_betas", (1, cfg["outputs"]["decshape"]), "init_shape"),
             (h + "init_expression", (1, cfg["outputs"]["decexpression"]), "init_shape"),
             (h + "init_depth", (1, 1), "init_depth")]
    return spec


def make_state(cfg: Mapping, seed: int, device) -> Dict[str, Tensor]:
    """Multi-HMR's state dict from ``seed``: float32 tensors on ``device``,
    one normal and one uniform draw of one generator, cut leaf by leaf. The
    backbone's linears, position embedding and CLS token are normal with
    std 0.02 (DINOv2's truncation at ±2 never binds); LayerScale's γ is
    uniform in [0.05, 1], the magnitudes of trained blocks (DINOv2 starts
    it at 1e-5, at which a block barely moves the tokens); the rest as
    PyTorch's defaults draw them; the mean pose the identity perturbed,
    the mean shape and expression small, the mean depth about 10 m."""
    spec = model_spec(cfg)
    shapes = {n: s for n, s, _ in spec}
    g = torch.Generator(device=device).manual_seed(seed)
    n_uniform = sum(math.prod(s) for _, s, k in spec if k in ("uniform", "gamma"))
    n_normal = sum(math.prod(s) for _, s, k in spec
                   if k not in ("uniform", "gamma", "zero", "one"))
    u = torch.rand(n_uniform, generator=g, device=device)
    z = torch.randn(n_normal, generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind in ("uniform", "gamma"):
            v = u[iu:iu + n].view(shape)
            iu += n
            if kind == "gamma":
                out[name] = 0.05 + 0.95 * v
            else:
                out[name] = (2.0 * v - 1.0) * _fan_in(name, shapes) ** -0.5
        else:
            v = z[iz:iz + n].view(shape)
            iz += n
            if kind == "vit_w":
                out[name] = v * 0.02
            elif kind == "init_pose":   # (1, 0, 0, 1, 0, 0) a joint: the identity, perturbed
                ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], device=device)
                out[name] = ident.repeat(shape[1] // 6)[None] + 0.05 * v
            elif kind == "init_shape":
                out[name] = 0.1 * v
            elif kind == "init_depth":
                out[name] = math.log(10.0) + 0.05 * v
            else:
                raise ValueError(f"unknown kind {kind!r}")
    return out


def make_body(seed: int, num_vertices: int, device, num_expression: int = 10) -> Dict[str, Tensor]:
    """``reference/weights.py``'s synthetic SMPL-X, with ``num_expression``
    expression directions (V, 3, E) drawn as its shape directions are, from
    a second generator."""
    body = make_smplx(seed, num_vertices, device)
    g = torch.Generator(device=device).manual_seed((seed + 1) % (1 << 63))
    body["expr_dirs"] = torch.randn((num_vertices, 3, num_expression), generator=g,
                                    device=device) * 0.01
    return body


# ---- the backbone --------------------------------------------------------------------

def backbone(sd: Mapping[str, Tensor], cfg: Mapping, frames: Tensor,
             levels: Optional[int] = None) -> Tensor:
    """(N, S, S, 3) RGB 0-255 → tokens (N, T, width) float32, the CLS token
    first."""
    vb = cfg["backbone"]
    e = "backbone.encoder."
    mean = torch.tensor(IMG_MEAN, device=frames.device)
    std = torch.tensor(IMG_STD, device=frames.device)
    x = (frames.float() / 255.0 - mean) / std
    h = F.conv2d(x.permute(0, 3, 1, 2), sd[e + "patch_embed.proj.weight"],
                 sd[e + "patch_embed.proj.bias"], stride=vb["patch"])
    gh, gw = h.shape[2:]
    h = h.flatten(2).transpose(1, 2)
    pos = sd[e + "pos_embed"]
    n = vb["pos_grid"]
    grid = F.interpolate(pos[:, 1:].reshape(1, n, n, -1).permute(0, 3, 1, 2), size=(gh, gw),
                         mode="bicubic", align_corners=False).flatten(2).transpose(1, 2)
    cls = (sd[e + "cls_token"] + pos[:, :1]).expand(h.shape[0], 1, h.shape[2])
    h = torch.cat([cls, h + grid], dim=1)
    C = vb["width"]
    for i in range(vb["depth"]):
        b = f"{e}blocks.{i}."
        y = F.layer_norm(h, (C,), sd[b + "norm1.weight"], sd[b + "norm1.bias"], 1e-6)
        q, k, v = _lin(y, sd, b + "attn.qkv", levels).chunk(3, dim=-1)
        h = h + sd[b + "ls1.gamma"] * _lin(_attend(q, k, v, vb["heads"]), sd, b + "attn.proj",
                                           levels)
        y = F.layer_norm(h, (C,), sd[b + "norm2.weight"], sd[b + "norm2.bias"], 1e-6)
        y = F.gelu(_lin(y, sd, b + "mlp.fc1", levels))
        h = h + sd[b + "ls2.gamma"] * _lin(y, sd, b + "mlp.fc2", levels)
    return F.layer_norm(h, (C,), sd[e + "last_norm.weight"], sd[e + "last_norm.bias"], 1e-6)


# ---- camera embedding, detection, head ------------------------------------------------

def camera_embedding(cfg: Mapping, intr: Tensor) -> Tensor:
    """intr (N, 3, 3) → (N, T, 3·(1 + 2·bands)): each token's ray's Fourier
    features, the CLS token's (the frame's centre) first."""
    vb, ce = cfg["backbone"], cfg["camera_embedding"]
    p, g = vb["patch"], vb["grid"]
    dt, dev = intr.dtype, intr.device
    h, w = vb["img_size"]
    centres = (torch.arange(g, dtype=dt, device=dev) + 0.5) * p
    u = torch.cat([torch.tensor([w / 2.0], dtype=dt, device=dev), centres.repeat(g)])
    v = torch.cat([torch.tensor([h / 2.0], dtype=dt, device=dev), centres.repeat_interleave(g)])
    rays = []
    for k in intr:
        d = torch.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], torch.ones_like(u)], -1)
        rays.append(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    d = torch.stack(rays)
    f = torch.linspace(1.0, ce["max_resolution"] / 2, ce["bands"], dtype=dt, device=dev)
    x = (math.pi * d[..., None] * f).flatten(-2)
    return torch.cat([d, torch.sin(x), torch.cos(x)], dim=-1)


def _mlp(x: Tensor, sd: Mapping[str, Tensor], name: str) -> Tensor:
    return _lin(F.relu(_lin(x, sd, name + ".0")), sd, name + ".2")


def scores(sd: Mapping[str, Tensor], cfg: Mapping, tokens: Tensor) -> Tensor:
    """tokens (N, T, C) → the detection score map (N, grid, grid)."""
    g = cfg["backbone"]["grid"]
    return torch.sigmoid(_mlp(tokens[:, 1:], sd, "mlp_classif")[..., 0]).reshape(-1, g, g)


def head(sd: Mapping[str, Tensor], cfg: Mapping, context: Tensor,
         patch: Tensor) -> Tuple[Tensor, ...]:
    """One image: context (T, context_dim), its persons' patches (n,) →
    (pose6d (n, 318), betas (n, 10), expression (n, 10), depth (n,))."""
    hd = cfg["head"]
    D, H = hd["dim"], hd["heads"]
    h = "x_attention_head."
    mean = torch.cat([sd[h + "init_body_pose"], sd[h + "init_betas"], sd[h + "init_expression"]],
                     dim=-1)
    x = (_lin(context[1 + patch], sd, h + "to_token_embedding")
         + _lin(mean, sd, h + "embed_init"))[None]                             # (1, n, D)
    ctx = context[None]

    def ln(y, name):
        return F.layer_norm(y, (D,), sd[name + ".weight"], sd[name + ".bias"], 1e-5)
    for i in range(hd["xat_depth"]):
        L = f"{h}transformer.layers.{i}."
        q, k, v = _lin(ln(x, L + "0.norm"), sd, L + "0.fn.to_qkv", bias=False).chunk(3, dim=-1)
        x = x + _lin(_attend(q, k, v, H), sd, L + "0.fn.to_out.0")
        y = ln(x, L + "1.norm")
        k, v = _lin(ctx, sd, L + "1.fn.to_kv", bias=False).chunk(2, dim=-1)
        q = _lin(y, sd, L + "1.fn.to_q", bias=False)
        x = x + _lin(_attend(q, k, v, H), sd, L + "1.fn.to_out.0")
        y = F.gelu(_lin(ln(x, L + "2.norm"), sd, L + "2.fn.net.0"))
        x = x + _lin(y, sd, L + "2.fn.net.3")
    x = x[0]
    return (_lin(x, sd, h + "decpose") + sd[h + "init_body_pose"],
            _lin(x, sd, h + "decshape") + sd[h + "init_betas"],
            _lin(x, sd, h + "decexpression") + sd[h + "init_expression"],
            torch.exp(_lin(x, sd, h + "decdepth") + sd[h + "init_depth"])[:, 0])


# ---- the body and the camera --------------------------------------------------------------

def smplx(body: Mapping[str, Tensor], betas: Tensor, expression: Tensor,
          rot53: Tensor) -> Tuple[Tensor, Tensor]:
    """betas (P, 10), expression (P, 10), rotations (P, 53, 3, 3) of the
    root, 21 body joints, jaw and 30 hand joints → vertices (P, V, 3), the
    127 joints (P, 127, 3)."""
    P = betas.shape[0]
    dev, dt = betas.device, betas.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    rot = torch.cat([rot53[:, :23], eye.expand(P, 2, 3, 3), rot53[:, 23:]], dim=1)  # (P, 55)
    v_shaped = (body["v_template"][None]
                + torch.einsum("bs,vcs->bvc", betas, body["shape_dirs"])
                + torch.einsum("bs,vcs->bvc", expression, body["expr_dirs"]))
    j_rest = torch.einsum("jv,bvc->bjc", body["j_regressor"], v_shaped)
    v_posed = v_shaped + ((rot[:, 1:] - eye).reshape(P, -1) @ body["pose_dirs"]).reshape(P, -1, 3)
    parents = SMPLX_PARENTS
    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, list(parents[1:])]], dim=1)
    local = torch.cat([torch.cat([rot, rel[..., None]], dim=-1),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=dev
                                    ).expand(P, 55, 1, 4)], dim=-2)
    world = local.clone()
    for js, ps in _levels(parents):
        world[:, js] = world[:, ps] @ local[:, js]
    tf = world.clone()
    tf[..., :3, 3] -= torch.einsum("bjik,bjk->bji", world[..., :3, :3], j_rest)
    T = torch.einsum("vj,bjk->bvk", body["lbs_weights"], tf.reshape(P, 55, 16)).reshape(P, -1, 4, 4)
    verts = torch.einsum("bvij,bvj->bvi", T[..., :3, :3], v_posed) + T[..., :3, 3]
    lmk = torch.einsum("blvc,lv->blc", verts[:, body["lmk_vert_ids"]], body["lmk_bary"])
    return verts, torch.cat([world[..., :3, 3], verts[:, body["extra_joint_ids"]], lmk], dim=1)


def perceive_tail(sd, cfg, body, tokens: Tensor, intr: Tensor, image: Tensor, patch: Tensor,
                  dtype: torch.dtype = torch.float32) -> Tuple[Tensor, ...]:
    """What follows the backbone, in ``dtype`` (the control runs it in
    bfloat16): tokens (N, T, C), intr (N, 3, 3) and the persons' images and
    patches (P,) → (body-frame vertices (P, V, 3), 2D joints (P, 127, 2),
    translations (P, 3), score map (N, grid, grid)), float32."""
    if dtype != torch.float32:
        def cast(d):
            return {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}
        sd, body = cast(sd), cast(body)
        tokens, intr = tokens.to(dtype), intr.to(dtype)
    g, p = cfg["backbone"]["grid"], cfg["backbone"]["patch"]
    s = scores(sd, cfg, tokens)
    context = torch.cat([tokens, camera_embedding(cfg, intr)], dim=-1)
    outs = []
    for n in range(tokens.shape[0]):
        mine = (image == n).nonzero()[:, 0]
        if len(mine):
            outs.append(head(sd, cfg, context[n], patch[mine]))
    if not outs:
        V, e = body["v_template"].shape[0], tokens.new_zeros(0, 1, 1).float()
        return e.expand(0, V, 3), e.expand(0, 127, 2), e[:, 0].expand(0, 3), s.float()
    pose, betas, expr, depth = (torch.cat(parts) for parts in zip(*outs))
    off = torch.sigmoid(_mlp(tokens[image, 1 + patch], sd, "mlp_offset"))
    uv = (torch.stack([patch % g, patch // g], dim=-1).to(dtype) + off) * p
    k = intr[image]
    trans = depth[:, None] * torch.stack([(uv[:, 0] - k[:, 0, 2]) / k[:, 0, 0],
                                          (uv[:, 1] - k[:, 1, 2]) / k[:, 1, 1],
                                          torch.ones_like(depth)], dim=-1)
    verts, joints = smplx(body, betas, expr, rot6d_to_rotmat(pose.reshape(-1, NUM_POSE_JOINTS, 6)))
    cam_j = joints + trans[:, None]
    f = torch.stack([k[:, 0, 0], k[:, 1, 1]], -1)[:, None]
    j2d = cam_j[..., :2] / cam_j[..., 2:] * f + k[:, None, :2, 2]
    return verts.float(), j2d.float(), trans.float(), s.float()
