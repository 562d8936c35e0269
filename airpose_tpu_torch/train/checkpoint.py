"""Weight carry between the JAX package and the port.

The common format is the reference AirPose state dict that
airpose_tpu/train/checkpoint.py::export_reference_checkpoint writes: keys
under ``model.``, OIHW convolutions, (out, in) linears, BatchNorm as
weight/bias/running_mean/running_var/num_batches_tracked, the mean-parameter
buffers, and the dead ``deccam`` head the reference net defines but never
calls.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.regressor import load_mean_params

_HEADS = ("fc1", "fc2", "decpose", "decshape")


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


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX AirPoseTwoView ``{"params", "batch_stats"}`` tree (numpy
    leaves) → the reference two-view state dict, key for key what
    ``export_reference_checkpoint(variables, "copenet_twoview", path)``
    writes under ``"state_dict"``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet_entries(params["trunk"], stats["trunk"], sd, "model.")
    for name in _HEADS:
        sd[f"model.{name}.weight"] = _t(np.asarray(params["core"][name]["kernel"]).T)
        sd[f"model.{name}.bias"] = _t(params["core"][name]["bias"])
    pose, shape, cam = load_mean_params()
    sd["model.init_pose"] = torch.from_numpy(pose[None].copy())
    sd["model.init_shape"] = torch.from_numpy(shape[None].copy())
    sd["model.init_cam"] = torch.from_numpy(cam[None].copy())
    sd["model.deccam.weight"] = torch.zeros(3, 1024)
    sd["model.deccam.bias"] = torch.zeros(3)
    return sd


def _module_key(key: str) -> str:
    head = key.split(".", 1)[0]
    if head in _HEADS:
        return "core." + key
    if head.startswith("init_"):
        return key
    return "trunk." + key


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]):
    """Load a reference two-view state dict (or a checkpoint holding one
    under ``"state_dict"``) into an AirPoseTwoView with ``strict=True``.
    Only the ``model.`` prefix is stripped and only the dead ``deccam.*``
    keys are dropped."""
    sd = sd.get("state_dict", sd)
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    return model.load_state_dict(
        {_module_key(k): v for k, v in sd.items() if not k.startswith("deccam.")},
        strict=True)
