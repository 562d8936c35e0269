"""Plain HMR 2.0 (4D-Humans: ``hmr2/models/backbones/vit.py``,
``heads/smpl_head.py``, ``components/pose_transformer.py``), SMPL, the crop
camera's translation and the projection, over a state dict in the published
layout; float32 with TF32 off.

* Backbone: the middle ``img_size`` columns of the crop, a patch convolution
  (stride = kernel, padding ``padding``), the position embedding
  ``pos[:, 1:] + pos[:, :1]``, ``depth`` pre-norm blocks of explicit
  softmax(QKᵀ/√d)V attention (biased qkv) and a GELU MLP, LayerNorm eps
  1e-6, the last LayerNorm. With ``levels`` (the control) every linear of
  the blocks takes int8-style operands: weights symmetric per output
  channel, inputs symmetric per tensor, each at max|·| / levels, rounded
  half to even.
* Head: the zero token embedded by Linear(1 → dim) plus its position
  embedding; per layer self-attention, cross-attention over the tokens
  (no bias on q, k, v) and a GELU MLP, each pre-norm (eps 1e-5) and
  residual; the three readouts added to the mean parameters.
* 6D → rotation as HMR 2.0 reads it: the first three numbers are the first
  column, the next three the second; Gram-Schmidt; the third their cross.
* SMPL: shape and pose blend shapes, the joint regressor, the rigid chain of
  24 joints, skinning as an einsum pair; the 45 joints are the 24 and 21
  vertex picks.
* The crop camera (s, tx, ty) to a camera-frame translation by
  ``cam_crop_to_full`` with the drone camera's focal length and principal
  point; the joints projected with the same camera.

The weights maker draws the published initialisation from the seed: the
backbone's linears and position embedding normal with std 0.02 (the
truncation at ±2 never binds), zero biases, LayerNorm 1 and 0, the patch
convolution and the head's linears uniform in ±1/√fan_in (PyTorch's
default), the head's position embedding standard normal; the mean
parameters near the identity pose, zero shape and (0.9, 0, 0).
"""

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

from .smplx import _levels

Tensor = torch.Tensor
Spec = List[Tuple[str, Tuple[int, ...], str]]

SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                20, 21)
NUM_EXTRA = 21


# ---- the state dict ------------------------------------------------------------------

def _linear(name: str, fan_in: int, fan_out: int, kind: str, bias: bool = True) -> Spec:
    out = [(f"{name}.weight", (fan_out, fan_in), kind)]
    if bias:
        out.append((f"{name}.bias", (fan_out,), "zero" if kind == "vit_w" else kind))
    return out


def _norm(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero")]


def model_spec(cfg: Mapping) -> Spec:
    """Every tensor of HMR2's state dict, with its shape and the kind of
    draw that fills it."""
    vb, hd = cfg["backbone"], cfg["head"]
    C, p = vb["width"], vb["patch"]
    n_tok = vb["tokens"]
    spec = [("backbone.pos_embed", (1, n_tok + 1, C), "vit_w"),
            ("backbone.patch_embed.proj.weight", (C, 3, p, p), "uniform"),
            ("backbone.patch_embed.proj.bias", (C,), "uniform")]
    for i in range(vb["depth"]):
        b = f"backbone.blocks.{i}."
        spec += _norm(b + "norm1", C) + _linear(b + "attn.qkv", C, 3 * C, "vit_w")
        spec += _linear(b + "attn.proj", C, C, "vit_w") + _norm(b + "norm2", C)
        spec += _linear(b + "mlp.fc1", C, vb["mlp_ratio"] * C, "vit_w")
        spec += _linear(b + "mlp.fc2", vb["mlp_ratio"] * C, C, "vit_w")
    spec += _norm("backbone.last_norm", C)
    D, inner = hd["dim"], hd["heads"] * hd["dim_head"]
    t = "smpl_head.transformer."
    spec += _linear(t + "to_token_embedding", hd["token_dim"], D, "uniform")
    spec += [(t + "pos_embedding", (1, 1, D), "normal")]
    for i in range(hd["depth"]):
        L = f"{t}transformer.layers.{i}."
        spec += _norm(L + "0.norm", D) + _linear(L + "0.fn.to_qkv", D, 3 * inner, "uniform", False)
        spec += _linear(L + "0.fn.to_out.0", inner, D, "uniform")
        spec += _norm(L + "1.norm", D)
        spec += _linear(L + "1.fn.to_kv", hd["context_dim"], 2 * inner, "uniform", False)
        spec += _linear(L + "1.fn.to_q", D, inner, "uniform", False)
        spec += _linear(L + "1.fn.to_out.0", inner, D, "uniform")
        spec += _norm(L + "2.norm", D) + _linear(L + "2.fn.net.0", D, hd["mlp_dim"], "uniform")
        spec += _linear(L + "2.fn.net.3", hd["mlp_dim"], D, "uniform")
    for name, dim in cfg["outputs"].items():
        spec += _linear(f"smpl_head.{name}", D, dim, "uniform")
    spec += [("smpl_head.init_body_pose", (1, cfg["outputs"]["decpose"]), "init_pose"),
             ("smpl_head.init_betas", (1, 10), "init_shape"),
             ("smpl_head.init_cam", (1, 3), "init_cam")]
    return spec


def _fan_in(name: str, shapes: Mapping) -> int:
    """The fan-in of the layer ``name`` (a weight or its bias) belongs to."""
    return math.prod(shapes[name.rsplit(".", 1)[0] + ".weight"][1:])


def make_state(cfg: Mapping, seed: int, device) -> Dict[str, Tensor]:
    """HMR2's state dict from ``seed``: float32 tensors on ``device``, one
    normal and one uniform draw of one generator, cut leaf by leaf."""
    spec = model_spec(cfg)
    shapes = {n: s for n, s, _ in spec}
    g = torch.Generator(device=device).manual_seed(seed)
    n_uniform = sum(math.prod(s) for _, s, k in spec if k == "uniform")
    n_normal = sum(math.prod(s) for _, s, k in spec if k not in ("uniform", "zero", "one"))
    u = torch.rand(n_uniform, generator=g, device=device)
    z = torch.randn(n_normal, generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "uniform":
            bound = _fan_in(name, shapes) ** -0.5
            out[name] = (2.0 * u[iu:iu + n] - 1.0).view(shape) * bound
            iu += n
        else:
            v = z[iz:iz + n].view(shape)
            iz += n
            if kind == "vit_w":
                out[name] = v * 0.02
            elif kind == "normal":
                out[name] = v.clone()
            elif kind == "init_pose":   # (1, 0, 0, 0, 1, 0) a joint: the identity, perturbed
                ident = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=device)
                out[name] = ident.repeat(shape[1] // 6)[None] + 0.05 * v
            elif kind == "init_shape":
                out[name] = 0.1 * v
            elif kind == "init_cam":
                out[name] = torch.tensor([[0.9, 0.0, 0.0]], device=device) + 0.05 * v
            else:
                raise ValueError(f"unknown kind {kind!r}")
    return out


def make_smpl(seed: int, num_vertices: int, device, num_betas: int = 10) -> Dict[str, Tensor]:
    """A synthetic SMPL model with the published schema (not
    anthropometric): template (V, 3), shape directions (V, 3, 10), pose
    directions (23·9, V·3), joint regressor (24, V) and skinning weights
    (V, 24) each normalised to sum to one, and 21 vertex picks."""
    V, J = num_vertices, len(SMPL_PARENTS)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(V * 3 + V * 3 * num_betas + (J - 1) * 9 * V * 3, generator=g, device=device)
    u = torch.rand(J * V + V * J, generator=g, device=device)
    zs = torch.split(z, [V * 3, V * 3 * num_betas, (J - 1) * 9 * V * 3])
    jr = u[:J * V].view(J, V) ** 8
    w = u[J * V:].view(V, J) ** 4
    return {
        "v_template": zs[0].view(V, 3) * 0.3,
        "shape_dirs": zs[1].view(V, 3, num_betas) * 0.01,
        "pose_dirs": zs[2].view((J - 1) * 9, V * 3) * 0.001,
        "j_regressor": jr / jr.sum(dim=1, keepdim=True),
        "lbs_weights": w / w.sum(dim=1, keepdim=True),
        "extra_joint_ids": torch.randint(0, V, (NUM_EXTRA,), generator=g, device=device),
    }


# ---- the backbone --------------------------------------------------------------------

def _quantize(t: Tensor, levels: int, dim: Optional[int]) -> Tensor:
    """``t`` at the symmetric grid of max|t| / levels (per row of ``dim``, or
    per tensor), back in float32."""
    m = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    s = (m / levels).clamp_min(1e-12)
    return torch.round(t / s).clamp_(-levels, levels) * s


def _lin(x: Tensor, sd: Mapping[str, Tensor], name: str, levels: Optional[int] = None,
         bias: bool = True) -> Tensor:
    w = sd[f"{name}.weight"].to(x.dtype)
    if levels is not None:
        x, w = _quantize(x, levels, None), _quantize(w, levels, 1)
    b = sd[f"{name}.bias"].to(x.dtype) if bias else None
    return F.linear(x, w, b)


def _attend(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    """Explicit softmax(QKᵀ/√d)V over (B, N, H·d) operands → (B, N, H·d)."""
    B, Nq, _ = q.shape

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return (a @ v).transpose(1, 2).reshape(B, Nq, -1)


def backbone(sd: Mapping[str, Tensor], cfg: Mapping, x: Tensor,
             levels: Optional[int] = None) -> Tensor:
    """(N, S, S, 3) crops → tokens (N, tokens, width), float32."""
    vb = cfg["backbone"]
    m = (x.shape[2] - vb["img_size"][1]) // 2
    h = F.conv2d(x[:, :, m:x.shape[2] - m].permute(0, 3, 1, 2),
                 sd["backbone.patch_embed.proj.weight"], sd["backbone.patch_embed.proj.bias"],
                 stride=vb["patch"], padding=vb["padding"]).flatten(2).transpose(1, 2)
    pos = sd["backbone.pos_embed"]
    h = h + pos[:, 1:] + pos[:, :1]
    C = vb["width"]
    for i in range(vb["depth"]):
        b = f"backbone.blocks.{i}."
        y = F.layer_norm(h, (C,), sd[b + "norm1.weight"], sd[b + "norm1.bias"], 1e-6)
        q, k, v = _lin(y, sd, b + "attn.qkv", levels).chunk(3, dim=-1)
        h = h + _lin(_attend(q, k, v, vb["heads"]), sd, b + "attn.proj", levels)
        y = F.layer_norm(h, (C,), sd[b + "norm2.weight"], sd[b + "norm2.bias"], 1e-6)
        y = F.gelu(_lin(y, sd, b + "mlp.fc1", levels))
        h = h + _lin(y, sd, b + "mlp.fc2", levels)
    return F.layer_norm(h, (C,), sd["backbone.last_norm.weight"], sd["backbone.last_norm.bias"],
                        1e-6)


# ---- the head, the body and the camera ------------------------------------------------

def head(sd: Mapping[str, Tensor], cfg: Mapping, tokens: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """tokens (N, T, C) → pose 6D (N, 144), betas (N, 10), cam (N, 3), in
    the dtype of ``tokens`` and ``sd``."""
    hd = cfg["head"]
    D, H = hd["dim"], hd["heads"]
    t = "smpl_head.transformer."
    N = tokens.shape[0]
    x = _lin(tokens.new_zeros(N, 1, hd["token_dim"]), sd, t + "to_token_embedding")
    x = x + sd[t + "pos_embedding"]

    def ln(y, name):
        return F.layer_norm(y, (D,), sd[name + ".weight"], sd[name + ".bias"], 1e-5)
    for i in range(hd["depth"]):
        L = f"{t}transformer.layers.{i}."
        q, k, v = _lin(ln(x, L + "0.norm"), sd, L + "0.fn.to_qkv", bias=False).chunk(3, dim=-1)
        x = x + _lin(_attend(q, k, v, H), sd, L + "0.fn.to_out.0")
        y = ln(x, L + "1.norm")
        k, v = _lin(tokens, sd, L + "1.fn.to_kv", bias=False).chunk(2, dim=-1)
        q = _lin(y, sd, L + "1.fn.to_q", bias=False)
        x = x + _lin(_attend(q, k, v, H), sd, L + "1.fn.to_out.0")
        y = F.gelu(_lin(ln(x, L + "2.norm"), sd, L + "2.fn.net.0"))
        x = x + _lin(y, sd, L + "2.fn.net.3")
    x = x[:, 0]
    return (_lin(x, sd, "smpl_head.decpose") + sd["smpl_head.init_body_pose"],
            _lin(x, sd, "smpl_head.decshape") + sd["smpl_head.init_betas"],
            _lin(x, sd, "smpl_head.deccam") + sd["smpl_head.init_cam"])


def rot6d_to_rotmat(x: Tensor) -> Tensor:
    """(..., 6) in HMR 2.0's layout → (..., 3, 3)."""
    a1, a2 = x[..., :3], x[..., 3:]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def smpl(body: Mapping[str, Tensor], betas: Tensor, rot: Tensor) -> Tuple[Tensor, Tensor]:
    """betas (B, 10), rotations of the 24 joints (B, 24, 3, 3), the root's
    first → vertices (B, V, 3), joints (B, 45, 3)."""
    B, J = rot.shape[:2]
    dev, dt = betas.device, betas.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    v_shaped = body["v_template"][None] + torch.einsum("bs,vcs->bvc", betas, body["shape_dirs"])
    j_rest = torch.einsum("jv,bvc->bjc", body["j_regressor"], v_shaped)
    v_posed = v_shaped + ((rot[:, 1:] - eye).reshape(B, -1) @ body["pose_dirs"]).reshape(B, -1, 3)
    parents = SMPL_PARENTS
    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, list(parents[1:])]], dim=1)
    local = torch.cat([torch.cat([rot, rel[..., None]], dim=-1),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=dev
                                    ).expand(B, J, 1, 4)], dim=-2)
    world = local.clone()
    for js, ps in _levels(parents):
        world[:, js] = world[:, ps] @ local[:, js]
    tf = world.clone()
    tf[..., :3, 3] -= torch.einsum("bjik,bjk->bji", world[..., :3, :3], j_rest)
    T = torch.einsum("vj,bjk->bvk", body["lbs_weights"], tf.reshape(B, J, 16)).reshape(B, -1, 4, 4)
    verts = torch.einsum("bvij,bvj->bvi", T[..., :3, :3], v_posed) + T[..., :3, 3]
    return verts, torch.cat([world[..., :3, 3], verts[:, body["extra_joint_ids"]]], dim=1)


def cam_crop_to_full(cam: Tensor, bb: Tensor, intr: Tensor, crop: int) -> Tensor:
    """HMR 2.0's ``cam_crop_to_full``: (s, tx, ty) of a crop whose box centre
    is (bb[:2] + 1)·principal point and whose side is crop / bb[2] →
    (tx + 2(cx − px)/(b·s), ty + 2(cy − py)/(b·s), 2f/(b·s)), the focal
    length f and principal point (px, py) from ``intr``."""
    f, pp = intr[..., 0, 0], intr[..., :2, 2]
    bs = crop / bb[..., 2] * cam[..., 0] + 1e-9
    centre = (bb[..., :2] + 1.0) * pp
    return torch.stack([2 * (centre[..., 0] - pp[..., 0]) / bs + cam[..., 1],
                        2 * (centre[..., 1] - pp[..., 1]) / bs + cam[..., 2], 2 * f / bs], -1)


def perceive_tail(sd, cfg, body, tokens: Tensor, bb: Tensor, intr: Tensor, crop: int,
                  dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
    """What follows the backbone: the head, 6D → rotations, SMPL, the
    translation and the projection. tokens (B, 2, T, C) → (vertices
    (B, 2, V, 3), j2d (B, 2, 45, 2)) in float32, computed in ``dtype``
    (the control runs it in bfloat16)."""
    if dtype != torch.float32:
        def cast(d):
            return {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}
        sd, body = cast(sd), cast(body)
        tokens, bb, intr = (t.to(dtype) for t in (tokens, bb, intr))
    B = tokens.shape[0]
    pose, betas, cam = head(sd, cfg, tokens.flatten(0, 1))
    rot = rot6d_to_rotmat(pose.reshape(B * 2, -1, 6))
    verts, joints = smpl(body, betas, rot)
    trans = cam_crop_to_full(cam.reshape(B, 2, 3), bb, intr, crop)
    cam_j = joints.reshape(B, 2, -1, 3) + trans[:, :, None]
    f = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], -1)[:, :, None]
    j2d = cam_j[..., :2] / cam_j[..., 2:] * f + intr[..., :2, 2][:, :, None]
    return verts.reshape(B, 2, -1, 3).float(), j2d.float()
