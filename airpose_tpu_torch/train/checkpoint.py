"""Checkpoints and weight carry between the JAX package and the port.

The common format is the reference AirPose state dict that
airpose_tpu/train/checkpoint.py::export_reference_checkpoint writes for each
model family: keys under ``model.`` (``model.copenet{v}.`` per drone for
the ``_sep`` family), OIHW convolutions, (out, in) linears, BatchNorm as
weight/bias/running_mean/running_var/num_batches_tracked, the mean-parameter
buffers, and the ``deccam`` head, live in hmr and muhmr and dead (defined,
never called) in the full-camera families. ``int8_operands_from_jax``
carries the JAX package's quantized int8 trunk operands and calibration
table.

``CheckpointManager`` (port of the JAX package's orbax manager) keeps
``best`` and ``last`` as single ``torch.save`` files in the reference
Lightning layout: ``"state_dict"`` as above, in f32, beside ``global_step``
and the AMSGrad state by parameter name. The JAX package reads them with
``load_model_variables(family, torch_ckpt=...)``. The port never reads orbax:
``export_reference_checkpoint`` carries an orbax checkpoint across.
"""

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import MODEL_REGISTRY
from ..models.regressor import load_mean_params
from .state import TrainState, model_variables

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
        _put_constant_entries(sd, prefix, model_name)
    return sd


def _put_constant_entries(sd: Dict[str, torch.Tensor], prefix: str, model_name: str) -> None:
    """The entries of one net that no training changes, where ``sd`` lacks
    them: the mean-parameter buffers (``init_position`` for the single-view
    model, ``init_cam`` for the rest) and the zero ``deccam`` head of the
    families whose head is dead."""
    pose, shape, cam = load_mean_params()
    sd.setdefault(f"{prefix}init_pose", torch.from_numpy(pose[None].copy()))
    sd.setdefault(f"{prefix}init_shape", torch.from_numpy(shape[None].copy()))
    if model_name == "copenet_singleview":
        sd.setdefault(f"{prefix}init_position", torch.tensor([[0.0, 0.0, 10.0 / 0.05]]))
    else:
        sd.setdefault(f"{prefix}init_cam", torch.from_numpy(cam[None].copy()))
    if model_name not in LIVE_DECCAM:
        sd.setdefault(f"{prefix}deccam.weight", torch.zeros(3, 1024))
        sd.setdefault(f"{prefix}deccam.bias", torch.zeros(3))


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


def _reference_key(name: str, model_name: str) -> str:
    """Inverse of ``_module_key``: a port model's tensor name → its
    reference key, ``trunk{v}.``/``core{v}.`` → ``model.copenet{v}.`` for
    the ``_sep`` family, ``trunk.``/``core.`` → ``model.`` for the rest."""
    head, rest = name.split(".", 1) if "." in name else ("", name)
    if model_name == SEP:
        return f"model.copenet{head[-1]}.{rest}"
    return "model." + (rest if head in ("trunk", "core") else name)


def reference_state_dict(tensors: Mapping[str, torch.Tensor],
                         model_name: str = "copenet_twoview") -> Dict[str, torch.Tensor]:
    """The port's parameters and BatchNorm statistics by name (a TrainState's
    ``params`` and ``batch_stats``, or a model's ``state_dict()``) → the
    reference state dict of ``model_name``'s family, on the CPU in f32
    (integer counters as they are): the keys ``export_reference_checkpoint``
    writes, the mean-parameter buffers and the dead ``deccam`` head
    included. The inverse of ``load_reference_state_dict``."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model family: {model_name}")
    sd: Dict[str, torch.Tensor] = {}
    for name, t in tensors.items():
        t = t.detach().to("cpu", copy=True)
        sd[_reference_key(name, model_name)] = t.float() if t.is_floating_point() else t
    for prefix in ([f"model.copenet{v}." for v in (0, 1)] if model_name == SEP
                   else ["model."]):
        _put_constant_entries(sd, prefix, model_name)
    return sd


class CheckpointManager:
    """Keeps ``best`` (lowest val_loss) and ``last`` of one model family's
    TrainState under ``directory`` as ``best.ckpt`` and ``last.ckpt``.

    Replaces Lightning's ModelCheckpoint(val_loss, save_top_k=1,
    save_last=True) + resume-from-last (ref copenet/copenet_trainer.py:42-53)
    and the HTCondor deadline checkpoint-exit-resume cycle (ref
    copenet_trainer_cluster.py:44-60 — see ``train/elastic.py``)."""

    def __init__(self, directory: str, model_name: str = "copenet_twoview"):
        if model_name not in MODEL_REGISTRY:
            raise ValueError(f"unknown model family: {model_name}")
        self.directory = os.path.abspath(directory)
        self.model_name = model_name
        os.makedirs(self.directory, exist_ok=True)
        # best_val survives preemption restarts so a resumed run cannot
        # overwrite `best` with a worse state
        self._meta_path = os.path.join(self.directory, "best_val.json")
        self.best_val = float("inf")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best_val = float(json.load(f)["best_val"])

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.ckpt")

    def save(self, state: TrainState, name: str = "last"):
        opt = state.opt_state
        blob = {
            "state_dict": reference_state_dict({**state.params, **state.batch_stats},
                                               self.model_name),
            "global_step": int(state.step),
            "optimizer": {"count": int(opt["count"]),
                          **{k: {n: t.detach().to("cpu", copy=True) for n, t in opt[k].items()}
                             for k in ("mu", "nu", "nu_max")}},
        }
        path = self._path(name)
        # written whole, then renamed: a preemption mid-write leaves the
        # previous checkpoint intact
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)

    def save_with_val(self, state: TrainState, val_loss: float):
        self.save(state, "last")
        if val_loss < self.best_val:
            self.best_val = val_loss
            self.save(state, "best")
            with open(self._meta_path, "w") as f:
                json.dump({"best_val": self.best_val}, f)

    @torch.no_grad()
    def restore(self, state: TrainState, name: str = "last") -> Optional[TrainState]:
        """Copy the checkpoint ``name`` into ``state``'s own tensors (step,
        parameters, BatchNorm statistics, optimizer state) and return it;
        None if there is no such checkpoint. Raises if the checkpoint holds
        another model or another optimizer's state."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        blob = torch.load(path, map_location="cpu", weights_only=True)
        saved = {}
        for k, v in blob["state_dict"].items():
            key = _module_key(k[len("model."):], self.model_name)
            if key is not None and not key.rsplit(".", 1)[-1].startswith("init_"):
                saved[key] = v
        live = {**state.params, **state.batch_stats}
        opt = blob["optimizer"]
        if set(saved) != set(live) or set(opt["mu"]) != set(state.opt_state["mu"]):
            raise ValueError(
                f"{path} holds another model or optimizer than the state: "
                f"tensors only there {sorted(set(saved) - set(live))[:8]}, only in the "
                f"state {sorted(set(live) - set(saved))[:8]}; optimizer entries "
                f"{len(opt['mu'])} there, {len(state.opt_state['mu'])} in the state")
        for n, t in live.items():
            t.copy_(saved[n])
        for k in ("mu", "nu", "nu_max"):
            for n, t in state.opt_state[k].items():
                t.copy_(opt[k][n])
        state.opt_state["count"] = int(opt["count"])
        state.step = int(blob["global_step"])
        return state

    def auto_resume(self, state: TrainState) -> TrainState:
        """Resume from ``last`` if present, else return the fresh state —
        the reference's resume_from_checkpoint behavior
        (copenet_trainer.py:49-53)."""
        restored = self.restore(state, "last")
        return restored if restored is not None else state


def load_model_variables(model_name: str, torch_ckpt: Optional[str] = None,
                         random_init: bool = False, device=None, ckpt: Optional[str] = None):
    """Inference-time weight loading shared by the serving/bench CLIs:
    returns ``(model, {"params", "batch_stats"})`` for one model family, the
    f32 model on ``device`` (CUDA by default; raises without it) and its own
    tensors by name. Exactly one source must be given: ``torch_ckpt``, a
    reference PyTorch-Lightning ``.ckpt`` (the port's checkpoints among them)
    or a bare state dict, loaded with ``strict=True``; or
    ``random_init=True`` (the seed-0 weights, the rehearsal mode). ``ckpt``,
    an orbax directory of the JAX package, raises: the port reads no orbax."""
    if ckpt is not None:
        raise ValueError(
            f"{ckpt}: the port reads no orbax checkpoint; write it as a reference "
            ".ckpt with airpose_tpu.train.checkpoint.export_reference_checkpoint "
            "and pass that as torch_ckpt")
    if (torch_ckpt is not None) + random_init != 1:
        raise ValueError("provide exactly one of --torch-ckpt or --random-init")
    dev = resolve_device(device)
    model = MODEL_REGISTRY[model_name]()
    if torch_ckpt is not None:
        blob = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
        load_reference_state_dict(model, blob, model_name)
    model = model.to(dev)
    return model, model_variables(model)


def load_imagenet_resnet50(path: str) -> Dict[str, torch.Tensor]:
    """Torchvision ResNet-50 weight file → the port's trunk state dict (the
    port's ResNet50 keeps torchvision's names).

    The reference loads torchvision's ImageNet ResNet-50 weights
    non-strictly at model construction (ref
    copenet/src/copenet/models/model_copenet.py:236-238); here the same
    warm start is explicit: point ``trainer --imagenet_ckpt`` at a saved
    ``resnet50-*.pth`` state dict (raw, or wrapped in ``{'state_dict':
    ...}``, keys optionally under DataParallel's ``module.``). The
    classifier ``fc.*`` entries and the ``num_batches_tracked`` counters are
    dropped, matching the reference's strict=False load."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj)
    prefix = "module." if any(k.startswith("module.") for k in sd) else ""
    return {k[len(prefix):]: v for k, v in sd.items()
            if not k[len(prefix):].startswith("fc.") and not k.endswith("num_batches_tracked")}


@torch.no_grad()
def warm_start_trunks(params: Dict[str, torch.Tensor], batch_stats: Dict[str, torch.Tensor],
                      trunk: Mapping[str, torch.Tensor], model_name: str):
    """Copy a trunk state dict (``load_imagenet_resnet50``) into a model's
    parameters and BatchNorm statistics, in place, each tensor keeping its
    dtype and device; returns (params, batch_stats).

    Shared-trunk families get ``trunk``; the per-drone
    ``copenet_twoview_sep`` gets the same ImageNet weights in BOTH
    ``trunk0`` and ``trunk1`` (the reference constructs copenet0/copenet1
    each with pretrained=True, ref model_copenet_sep.py:169-237). Raises
    unless the trunk's entries and the model's trunk tensors match one to
    one in name and shape."""
    for prefix in (("trunk0", "trunk1") if model_name == SEP else ("trunk",)):
        dst = {n[len(prefix) + 1:]: t for n, t in {**params, **batch_stats}.items()
               if n.startswith(prefix + ".") and not n.endswith("num_batches_tracked")}
        if set(dst) != set(trunk):
            raise ValueError(
                f"trunk state dict does not match {prefix}: only in the file "
                f"{sorted(set(trunk) - set(dst))[:8]}, only in the model "
                f"{sorted(set(dst) - set(trunk))[:8]}")
        for k, t in dst.items():
            if t.shape != trunk[k].shape:
                raise ValueError(f"{prefix}.{k}: model {tuple(t.shape)}, "
                                 f"file {tuple(trunk[k].shape)}")
            t.copy_(trunk[k])
    return params, batch_stats
