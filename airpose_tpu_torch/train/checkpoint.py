"""Weight carry between the JAX package and the port.

The common format is the reference AirPose state dict that
airpose_tpu/train/checkpoint.py::export_reference_checkpoint writes for each
model family: keys under ``model.`` (``model.copenet{v}.`` per drone for
the ``_sep`` family), OIHW convolutions, (out, in) linears, BatchNorm as
weight/bias/running_mean/running_var/num_batches_tracked, the mean-parameter
buffers, and the ``deccam`` head, live in hmr and muhmr and dead (defined,
never called) in the full-camera families. ``int8_operands_from_jax``
carries the JAX package's quantized int8 trunk operands and calibration
table.
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models import MODEL_REGISTRY
from ..models.regressor import load_mean_params

_HEADS = ("fc1", "fc2", "decpose", "decshape")
SEP = "copenet_twoview_sep"
LIVE_DECCAM = ("hmr", "muhmr")  # the weak-camera families regress the camera


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _resnet_entries(params, stats, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    def put_conv(key, kernel):  # flax HWIO → torch OIHW
        sd[prefix + key] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))

    def put_bn(key, p, s):
        sd[prefix + key + ".weight"] = _t(p["scale"])
        sd[prefix + key + ".bias"] = _t(p["bias"])
        sd[prefix + key + ".running_mean"] = _t(s["mean"])
        sd[prefix + key + ".running_var"] = _t(s["var"])
        sd[prefix + key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    put_conv("conv1.weight", params["conv1"]["kernel"])
    put_bn("bn1", params["bn1"], stats["bn1"])
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(n_blocks):
            src, dst = params[f"layer{stage}_{b}"], f"layer{stage}.{b}"
            st = stats[f"layer{stage}_{b}"]
            for ci in (1, 2, 3):
                put_conv(f"{dst}.conv{ci}.weight", src[f"conv{ci}"]["kernel"])
                put_bn(f"{dst}.bn{ci}", src[f"bn{ci}"], st[f"bn{ci}"])
            if "downsample_conv" in src:
                put_conv(f"{dst}.downsample.0.weight", src["downsample_conv"]["kernel"])
                put_bn(f"{dst}.downsample.1", src["downsample_bn"], st["downsample_bn"])


def state_dict_from_flax(variables: Mapping, model_name: str = "copenet_twoview"
                         ) -> Dict[str, torch.Tensor]:
    """A JAX model family's ``{"params", "batch_stats"}`` tree (numpy
    leaves) → its reference state dict, key for key what
    ``export_reference_checkpoint(variables, model_name, path)`` writes
    under ``"state_dict"``: the per-drone family under ``model.copenet{v}.``,
    the others under ``model.``; ``init_position`` for the single-view
    model, ``init_cam`` for the rest; zero ``deccam`` entries where the head
    is dead (every family but hmr and muhmr)."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model family: {model_name}")
    params, stats = variables["params"], variables["batch_stats"]
    live_cam = model_name in LIVE_DECCAM
    sd: Dict[str, torch.Tensor] = {}
    nets = ([(f"model.copenet{v}.", f"trunk{v}", f"core{v}") for v in (0, 1)]
            if model_name == SEP else [("model.", "trunk", "core")])
    for prefix, trunk, core in nets:
        _resnet_entries(params[trunk], stats[trunk], sd, prefix)
        for name in _HEADS + (("deccam",) if live_cam else ()):
            sd[f"{prefix}{name}.weight"] = _t(np.asarray(params[core][name]["kernel"]).T)
            sd[f"{prefix}{name}.bias"] = _t(params[core][name]["bias"])
        pose, shape, cam = load_mean_params()
        sd[f"{prefix}init_pose"] = torch.from_numpy(pose[None].copy())
        sd[f"{prefix}init_shape"] = torch.from_numpy(shape[None].copy())
        if model_name == "copenet_singleview":
            sd[f"{prefix}init_position"] = torch.tensor([[0.0, 0.0, 10.0 / 0.05]])
        else:
            sd[f"{prefix}init_cam"] = torch.from_numpy(cam[None].copy())
        if not live_cam:
            sd[f"{prefix}deccam.weight"] = torch.zeros(3, 1024)
            sd[f"{prefix}deccam.bias"] = torch.zeros(3)
    return sd


def _int8_conv(kernel) -> torch.Tensor:
    """HWIO int8 kernel → (Cout, kh·kw·Cin), k = (kh·KW + kw)·Cin + cin."""
    k = np.asarray(kernel, np.int8)
    return torch.from_numpy(k.transpose(3, 0, 1, 2).reshape(k.shape[3], -1).copy())


def _bf16_oihw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)).to(torch.bfloat16)


def int8_operands_from_jax(qparams: Mapping, act_scales: Mapping,
                           pblocks: Optional[Mapping] = None):
    """The JAX package's int8 operands, as numpy, → the port's.

    ``qparams`` is ``airpose_tpu.ops.int8_trunk.quantize_trunk_params``
    output (HWIO int8 ``wq``, bf16 ``wf``), ``act_scales`` its
    ``calibrate_act_scales`` table, ``pblocks`` (optional)
    ``int8_bottleneck.quantize_trunk_pallas`` output ((Cin, Cout) 1×1 and
    (9·Cmid, Cmid) 3×3 matrices). Returns (qparams, act_scales, blocks) as
    ``ops/int8_trunk.quantize_trunk_params``, ``calibrate_act_scales`` and
    ``ops/int8_bottleneck.quantize_trunk_blocks`` give them (blocks is None
    without ``pblocks``), so both packages compute on identical int8
    weights and scales."""
    out = {"stem": {"w": _bf16_oihw(qparams["stem"]["w"]), "b": _t(qparams["stem"]["b"])}}
    for name, blk in qparams.items():
        if name != "stem":
            out[name] = {conv: {"wq": _int8_conv(q["wq"]), "ws": _t(q["ws"]),
                                "b": _t(q["b"]), "wf": _bf16_oihw(q["wf"])}
                         for conv, q in blk.items()}
    scales = {k: float(v) for k, v in act_scales.items()}
    if pblocks is None:
        return out, scales, None
    blocks = []
    n = len(pblocks["blocks"])
    for i, blk in enumerate(pblocks["blocks"]):
        b = {"stride": 2 if "wp" in blk else 1, "out_int8": i + 1 < n}
        for k, v in blk.items():
            if k in ("w1", "w3", "wp", "w2"):  # (K, Cout) → (Cout, K)
                b[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.int8).T))
            elif k == "r":
                b[k] = _t(np.reshape(v, ()))
            elif k != "meta":
                b[k] = _t(v)
        blocks.append(b)
    return out, scales, {"s_in": float(pblocks["s_in"]), "blocks": blocks}


def _module_key(key: str, model_name: str) -> Optional[str]:
    """A reference key without ``model.`` → the port model's key, or None
    for the dead ``deccam`` head. The per-drone family's ``copenet{v}.``
    nets map to ``trunk{v}`` and ``core{v}``, their buffers to ``core{v}``."""
    view = ""
    if model_name == SEP:
        net, key = key.split(".", 1)
        view = net[len("copenet"):]
    head = key.split(".", 1)[0]
    if head == "deccam" and model_name not in LIVE_DECCAM:
        return None
    if head in _HEADS + ("deccam",):
        return f"core{view}.{key}"
    if head.startswith("init_"):
        return f"core{view}.{key}" if view else key
    return f"trunk{view}.{key}"


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                              model_name: str = "copenet_twoview"):
    """Load a reference state dict of ``model_name``'s family (or a
    checkpoint holding one under ``"state_dict"``) into the port's model
    with ``strict=True``. Only the ``model.`` prefix is stripped, and only
    the ``deccam`` entries of the families whose head is dead are dropped."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model family: {model_name}")
    sd = sd.get("state_dict", sd)
    out = {}
    for k, v in sd.items():
        key = _module_key(k[len("model."):] if k.startswith("model.") else k, model_name)
        if key is not None:
            out[key] = v
    return model.load_state_dict(out, strict=True)
