"""Seeded weights and the synthetic SMPL-X model, made on the device.

Each is drawn by one ``torch.Generator`` on the device in one call (a
normal or uniform draw of all values at once) and then scaled leaf by leaf,
so the same seed on the same device gives the same bits. The benchmark
loads the weights into the program's modules; the reference regenerates
them from the seed.

The state dict follows the published layout of the reference AirPose and
HMR checkpoints: ``trunk.`` (ResNet-50: ``conv1``, ``bn1``,
``layer{s}.{b}.conv{i}``, ``.bn{i}``, ``.downsample.0/1``), ``core.``
(``fc1``, ``fc2`` and one Linear per head) and the mean-parameter buffers
``init_pose`` (1, 144), ``init_shape`` (1, 10), ``init_cam`` (1, 3).
"""

import math
from typing import Dict, List, Mapping, Tuple

import torch

from .smplx import SMPLX_PARENTS, batch_rodrigues

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _bn(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
            (f"{name}.running_mean", (c,), "bn_mean"), (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def trunk_spec(trunk: Mapping, prefix: str = "trunk.") -> Spec:
    """A ResNet of bottleneck blocks: ``trunk`` holds ``blocks``, ``widths``,
    ``expansion``, ``stem_width`` and ``stem_kernel``."""
    stem, k = trunk["stem_width"], trunk["stem_kernel"]
    spec = [(f"{prefix}conv1.weight", (stem, 3, k, k), "conv")] + _bn(f"{prefix}bn1", stem)
    inplanes = stem
    for s, (planes, blocks) in enumerate(zip(trunk["widths"], trunk["blocks"]), start=1):
        out = planes * trunk["expansion"]
        for b in range(blocks):
            p = f"{prefix}layer{s}.{b}."
            spec += [(p + "conv1.weight", (planes, inplanes, 1, 1), "conv")] + _bn(p + "bn1", planes)
            spec += [(p + "conv2.weight", (planes, planes, 3, 3), "conv")] + _bn(p + "bn2", planes)
            spec += [(p + "conv3.weight", (out, planes, 1, 1), "conv")] + _bn(p + "bn3", out)
            if b == 0:
                spec += [(p + "downsample.0.weight", (out, inplanes, 1, 1), "conv")]
                spec += _bn(p + "downsample.1", out)
            inplanes = out
    return spec


def model_spec(cfg: Mapping) -> Spec:
    """Every tensor of the configuration's state dict, with its shape and
    the kind of draw that fills it."""
    hidden = cfg["fc_hidden"]
    spec = [("init_pose", (1, 144), "init_pose"), ("init_shape", (1, 10), "init_shape"),
            ("init_cam", (1, 3), "init_cam")]
    spec += trunk_spec(cfg["trunk"])
    spec += [("core.fc1.weight", (hidden, cfg["fc1_in"]), "fc_w"), ("core.fc1.bias", (hidden,), "fc_b"),
             ("core.fc2.weight", (hidden, hidden), "fc_w"), ("core.fc2.bias", (hidden,), "fc_b")]
    for name, dim in cfg["heads"].items():
        spec += [(f"core.{name}.weight", (dim, hidden), "head_w"),
                 (f"core.{name}.bias", (dim,), "head_b")]
    return spec


def _scaled(z: torch.Tensor, kind: str) -> torch.Tensor:
    shape = z.shape
    if kind == "conv":      # normal(0, sqrt(2 / fan_out)), He's initialisation
        return z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "fc_w":      # variance 1 / fan_in
        return z * math.sqrt(1.0 / shape[1])
    if kind == "head_w":    # Xavier with gain 0.01, as the IEF heads start near zero
        return z * 0.01 * math.sqrt(2.0 / (shape[0] + shape[1]))
    if kind == "bn_w":
        return 1.0 + 0.1 * z
    if kind == "bn_var":
        return torch.exp(0.2 * z)
    if kind in ("bn_b", "bn_mean", "init_shape"):
        return 0.1 * z
    if kind == "fc_b":
        return 0.01 * z
    if kind == "head_b":
        return 1e-4 * z
    if kind == "init_pose":  # the identity in 6D ([1, 0, 0, 1, 0, 0] a joint), perturbed
        ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], device=z.device).repeat(24)
        return ident + 0.05 * z
    if kind == "init_cam":   # weak-perspective (s, tx, ty) near (0.9, 0, 0)
        return torch.tensor([0.9, 0.0, 0.0], device=z.device) + 0.05 * z
    raise ValueError(f"unknown kind {kind!r}")


def make_state(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's state dict from ``seed``: float32 tensors on
    ``device`` (the BatchNorm counters int64 zeros)."""
    spec = model_spec(cfg)
    sizes = [math.prod(shape) for _, shape, kind in spec if kind != "count"]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        out[name] = _scaled(flat[off:off + n].view(shape), kind)
        off += n
    return out


def make_smplx(seed: int, num_vertices: int, device, num_joints: int = 55,
               num_betas: int = 10) -> Dict[str, torch.Tensor]:
    """A synthetic SMPL-X model with the published schema (not
    anthropometric): template (V, 3), shape directions (V, 3, 10), pose
    directions (54·9, V·3), joint regressor (55, V) and skinning weights
    (V, 55) each normalised to sum to one, the mean hand pose (30, 3, 3), 21
    vertex picks and 51 landmarks of three vertices each."""
    V, J = num_vertices, num_joints
    if J != len(SMPLX_PARENTS):
        raise ValueError(f"SMPL-X has {len(SMPLX_PARENTS)} joints, not {J}")
    g = torch.Generator(device=device).manual_seed(seed)
    n_normal = V * 3 + V * 3 * num_betas + (J - 1) * 9 * V * 3 + 30 * 3
    z = torch.randn(n_normal, generator=g, device=device)
    u = torch.rand(J * V + V * J + 51 * 3, generator=g, device=device)
    zs = torch.split(z, [V * 3, V * 3 * num_betas, (J - 1) * 9 * V * 3, 90])
    us = torch.split(u, [J * V, V * J, 51 * 3])
    jr = us[0].view(J, V) ** 8
    w = us[1].view(V, J) ** 4
    bary = us[2].view(51, 3)
    return {
        "v_template": zs[0].view(V, 3) * 0.3,
        "shape_dirs": zs[1].view(V, 3, num_betas) * 0.01,
        "pose_dirs": zs[2].view((J - 1) * 9, V * 3) * 0.001,
        "j_regressor": jr / jr.sum(dim=1, keepdim=True),
        "lbs_weights": w / w.sum(dim=1, keepdim=True),
        "hand_pose": batch_rodrigues(zs[3].view(30, 3) * 0.1),
        "extra_joint_ids": torch.randint(0, V, (21,), generator=g, device=device),
        "lmk_vert_ids": torch.randint(0, V, (51, 3), generator=g, device=device),
        "lmk_bary": bary / bary.sum(dim=1, keepdim=True),
    }
