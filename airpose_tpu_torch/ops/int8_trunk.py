"""int8 post-training-quantized ResNet-50 inference trunk (port of
airpose_tpu/ops/int8_trunk.py).

The trunk's folded-BN convolutions are quantized for inference:
  * weights: symmetric per-output-channel int8, scale = max|W|/127;
  * activations: symmetric per-tensor int8, static scales from
    ``calibrate_act_scales`` (or dynamic, ``act_scales=None``);
  * each conv runs as the int8 kernel of ops/int8_conv.py with int32
    accumulation and the f32 epilogue ``bf16(f32(acc)·(xs·ws) + b)``; the
    residual add and relu of a block's conv3 are fused into that epilogue;
  * with static scales, each conv's epilogue also quantizes its bf16 result
    at the next conv's scale (ops/int8_conv.py's ``qscale``), as XLA fused
    ``_quantize_act`` into the producing conv on the TPU: conv1 and conv2
    write only int8, conv3 writes the bf16 block output (the next block's
    residual) and its int8 at the next block's conv1 scale, which the next
    projection reuses when its scale is the same. Torch quantizes only the
    stem's output and the input of an int8 stage after a bf16 one; the
    dynamic path (``act_scales=None``, calibration) and the clip-rate
    diagnostic quantize every conv input in torch, on the bf16 map;
  * the stem stays a folded bf16 conv with its max-pool, bias and relu, on
    a card one kernel of ops/int8_stem.py, which sums in one order at every
    batch size;
    ``int8_stages`` keeps other stages as folded bf16 convs too (cuDNN's, whose
    order of summation depends on the batch size on a card).

Quantized parameters (``quantize_trunk_params``) are a dict like the JAX
one: ``"stem"`` {w (64, 3, 7, 7) bf16 OIHW, b f32} and per block
``"layer{s}_{b}"`` {conv1, conv2, conv3[, proj]}, each {wq (Cout, kh·kw·Cin)
int8, ws (Cout,) f32, b (Cout,) f32, wf OIHW bf16}. Activation scales are a
dict ``"layer{s}_{b}/conv{i}"`` / ``".../proj"`` → float. Tensors are NHWC.
"""

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.nn import functional as F

from ..utils.profiling import span
from . import _build
from .fused_bottleneck import fold_bn_into_conv
from .int8_conv import int8_conv, int8_conv_reference, quantize
from .int8_stem import stem as stem_fn

BF16 = torch.bfloat16
STAGES = (3, 4, 6, 3)


def quantize_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cout, K) f32 → (int8 (Cout, K), (Cout,) f32 scale), symmetric per
    output channel."""
    k = kernel.float()
    scale = (k.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.round(k / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _quantize_act(x: torch.Tensor, s=None, clip_collect: Optional[Dict] = None,
                  name: Optional[str] = None):
    """Per-tensor symmetric int8 of ``x`` in f32, rounding half to even →
    (int8 NHWC contiguous, scale). ``s=None`` takes the dynamic scale
    max|x|/127; with a static ``s``, ``clip_collect[name]`` records the
    fraction of values beyond 127.5·s, which the clip changes. Each call
    counts one ``quantize_act`` in ``_build.counts``."""
    _build.count("quantize_act")
    x = x.float()
    if s is None:
        s = (x.abs().amax() / 127.0).clamp_min(1e-12)
    elif clip_collect is not None:
        clip_collect[name] = (x.abs() > 127.5 * s).float().mean()
    return quantize(x, s).contiguous(), s


def _conv_entry(sd: Mapping[str, torch.Tensor], conv: str, bn: str) -> Dict[str, torch.Tensor]:
    w, b = fold_bn_into_conv(sd[f"{conv}.weight"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                             sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"])
    wq, ws = quantize_weight(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
    return {"wq": wq.contiguous(), "ws": ws, "b": b.contiguous(),
            "wf": w.to(BF16).contiguous()}


def quantize_trunk_params(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Fold BN into every conv of a ResNet-50 state dict (keys
    ``conv1.weight``, ``layer1.0.bn1.running_mean``, …, a
    ``ResNet50.state_dict()``) and quantize them; on the state dict's device."""
    out: Dict = {}
    stem = _conv_entry(sd, "conv1", "bn1")
    out["stem"] = {"w": stem["wf"], "b": stem["b"]}
    for stage, blocks in enumerate(STAGES, start=1):
        for blk in range(blocks):
            p = f"layer{stage}.{blk}."
            q = {f"conv{i}": _conv_entry(sd, f"{p}conv{i}", f"{p}bn{i}") for i in (1, 2, 3)}
            if f"{p}downsample.0.weight" in sd:
                q["proj"] = _conv_entry(sd, f"{p}downsample.0", f"{p}downsample.1")
            out[f"layer{stage}_{blk}"] = q
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _qconv(x: torch.Tensor, conv: Dict, ksize: int, stride: int = 1,
           act_scale=None, relu: bool = False, res: Optional[torch.Tensor] = None,
           conv_fn: Callable = int8_conv, collect: Optional[Dict] = None,
           clip_collect: Optional[Dict] = None, name: Optional[str] = None
           ) -> torch.Tensor:
    """Quantize ``x``, then one int8 conv through ``conv_fn`` with the
    epilogue ``bf16(f32(acc)·(xs·ws) + b)``; ``relu`` and a bf16 residual
    (``relu(y + res)``) are fused into it. (N, H, W, Cin) → bf16 NHWC."""
    xq, xs = _quantize_act(x, act_scale, clip_collect, name)
    if collect is not None:
        collect[name] = xs
    return _conv_q(xq, xs * conv["ws"], conv, ksize, stride, relu, res, conv_fn)


def _conv_q(xq: torch.Tensor, m: torch.Tensor, conv: Dict, ksize: int, stride: int = 1,
            relu: bool = False, res: Optional[torch.Tensor] = None,
            conv_fn: Callable = int8_conv, qscale: Optional[float] = None,
            out_dtype: torch.dtype = BF16):
    """One int8 conv of ``xq`` with the per-channel multiplier ``m`` = xs·ws
    (xs the scale of ``xq``) through ``conv_fn``: bf16 out, or with
    ``qscale`` the int8 of that bf16 result (``out_dtype`` int8) or both
    (bf16)."""
    if res is not None:
        res = res.contiguous()
    return conv_fn(xq, conv["wq"], m, conv["b"], ksize, stride, res=res,
                   relu=relu, out_dtype=out_dtype, qscale=qscale)


def _fconv(x: torch.Tensor, conv: Dict, stride: int = 1) -> torch.Tensor:
    """Folded-BN bf16 conv + f32 bias → bf16, for stages kept out of int8."""
    wf = conv["wf"]
    y = _nhwc(F.conv2d(_nchw(x).to(BF16), wf, stride=stride, padding=wf.shape[-1] // 2))
    return (y.float() + conv["b"]).to(BF16)


def int8_stem(stem: Dict, x: torch.Tensor) -> torch.Tensor:
    """The trunk's folded-BN bf16 stem: (N, H, W, 3) f32 → the
    (N, H/4, W/4, 64) bf16 map the int8 layers read: conv, max-pool, bias
    and relu, ops/int8_stem.py's ``stem`` (one kernel on a card, the plain
    version on the CPU)."""
    return stem_fn(x, stem["w"], stem["b"])


def resnet50_int8_infer(qparams: Dict, x: torch.Tensor, act_scales: Optional[Dict] = None,
                        int8_stages=(1, 2, 3, 4), use_kernels: bool = True,
                        conv: Optional[Callable] = None,
                        _collect: Optional[Dict] = None,
                        _clip_collect: Optional[Dict] = None) -> torch.Tensor:
    """(N, H, W, 3) f32 → (N, 2048) f32 GAP feature through the int8 convs.

    ``act_scales`` makes activation quantization static, and then each conv
    quantizes its output for the next conv in its epilogue; without it each
    conv input takes its dynamic scale. Stages outside ``int8_stages`` run
    folded-BN bf16 convs. Each int8 conv goes through ``conv``, any function
    with the signature of ``int8_conv.int8_conv`` (as
    ``int8_bottleneck.run_block`` takes one); by default ``int8_conv``, or
    with ``use_kernels=False`` its plain version on any device. The stem
    runs ops/int8_stem.py's kernel on a card either way (held to its own
    plain version apart): cuDNN's bf16 stem would sum in another order and
    flip some bf16 roundings that the int8 layers carry on. The GAP is an
    f32 mean over the bf16 map, not rounded to bf16."""
    conv_fn = conv or (int8_conv if use_kernels else int8_conv_reference)
    fused = act_scales is not None and _collect is None and _clip_collect is None
    order = [(stage, blk) for stage, blocks in enumerate(STAGES, start=1)
             for blk in range(blocks)]

    def scale(name):
        return None if act_scales is None else act_scales[name]

    def next_scale(i):
        """The conv1 scale of block i + 1 where that block is int8, else None."""
        if i + 1 == len(order) or order[i + 1][0] not in int8_stages:
            return None
        return act_scales["layer{}_{}/conv1".format(*order[i + 1])]

    with span("stem"):
        h = int8_stem(qparams["stem"], x)

    with span("int8_layers"):
        # the static path's per-conv multipliers xs·ws, in one launch
        convs = [(f"layer{st}_{blk}", key) for st, blk in order if fused and st in int8_stages
                 for key in ("proj", "conv1", "conv2", "conv3") if key in qparams[f"layer{st}_{blk}"]]
        mult = dict(zip(convs, torch._foreach_mul(
            [qparams[b][key]["ws"] for b, key in convs],
            [float(act_scales[f"{b}/{key}"]) for b, key in convs]))) if convs else {}
        hq = None  # h at the next block's conv1 scale, where conv3 wrote it
        for i, (stage, blk) in enumerate(order):
            int8 = stage in int8_stages
            bname = f"layer{stage}_{blk}"
            q = qparams[bname]
            stride = 2 if (stage > 1 and blk == 0) else 1

            def qconv(t, key, ksize, s=1, **kw):
                name = f"{bname}/{key}"
                return _qconv(t, q[key], ksize, s, scale(name), conv_fn=conv_fn,
                              collect=_collect, clip_collect=_clip_collect,
                              name=name, **kw)

            if int8 and fused:
                h, hq = _static_block(h, hq, q, bname, stride, act_scales, mult,
                                      next_scale(i), conv_fn)
                continue
            if "proj" in q:
                res = qconv(h, "proj", 1, stride) if int8 else _fconv(h, q["proj"], stride)
            else:
                res = h
            if int8:
                y = qconv(h, "conv1", 1, relu=True)
                y = qconv(y, "conv2", 3, stride, relu=True)
                h = qconv(y, "conv3", 1, relu=True, res=res)
            else:
                y = torch.relu(_fconv(h, q["conv1"]))
                y = torch.relu(_fconv(y, q["conv2"], stride))
                h = torch.relu(_fconv(y, q["conv3"]) + res)
        return h.float().mean(dim=(1, 2))


def _static_block(h: torch.Tensor, hq: Optional[torch.Tensor], q: Dict, bname: str,
                  stride: int, act_scales: Mapping, mult: Mapping,
                  s_next: Optional[float], conv_fn: Callable):
    """One int8 bottleneck block with static scales, each conv quantizing
    its output for the next conv. ``h`` is the bf16 block input and ``hq``
    its int8 at this block's conv1 scale (None: quantized here in torch);
    ``mult[(bname, conv)]`` is each conv's multiplier xs·ws.
    → (bf16 block output, its int8 at ``s_next``, or None without one)."""
    s1, s2, s3 = (act_scales[f"{bname}/conv{i}"] for i in (1, 2, 3))
    if hq is None:
        hq, _ = _quantize_act(h, s1)
    res = h
    if "proj" in q:
        sp = act_scales[f"{bname}/proj"]
        xp = hq if sp == s1 else _quantize_act(h, sp)[0]
        res = _conv_q(xp, mult[bname, "proj"], q["proj"], 1, stride, conv_fn=conv_fn)
    y = _conv_q(hq, mult[bname, "conv1"], q["conv1"], 1, relu=True, conv_fn=conv_fn,
                qscale=s2, out_dtype=torch.int8)
    y = _conv_q(y, mult[bname, "conv2"], q["conv2"], 3, stride, relu=True, conv_fn=conv_fn,
                qscale=s3, out_dtype=torch.int8)
    out = _conv_q(y, mult[bname, "conv3"], q["conv3"], 1, relu=True, res=res,
                  conv_fn=conv_fn, qscale=s_next)
    return out if s_next is not None else (out, None)


def calibrate_act_scales(qparams: Dict, sample_x: torch.Tensor) -> Dict[str, float]:
    """One dynamic-scale forward over ``sample_x``, recording every conv
    input's per-tensor scale: the table that makes later calls static."""
    collect: Dict = {}
    resnet50_int8_infer(qparams, sample_x, act_scales=None, _collect=collect)
    return {k: float(v) for k, v in collect.items()}


def calibration_clip_rates(qparams: Dict, act_scales: Dict, x: torch.Tensor,
                           int8_stages=(1, 2, 3, 4)) -> Dict[str, float]:
    """Per conv input, the fraction of ``x``'s activation values that
    saturate at ±127·scale under ``act_scales``: the calibration-adequacy
    diagnostic (a rate ≳ 1e-2 means an unrepresentative calibration set)."""
    collect: Dict = {}
    resnet50_int8_infer(qparams, x, act_scales=act_scales, int8_stages=int8_stages,
                        _clip_collect=collect)
    return {k: float(v) for k, v in collect.items()}


def twoview_int8_forward(model, qparams: Dict, act_scales: Dict, images: torch.Tensor,
                         bb: torch.Tensor, init_position: torch.Tensor,
                         int8_stages=(1, 2, 3, 4)):
    """AirPoseTwoView forward with the int8 trunk: int8 features of the
    view-folded crops (B, 2, H, W, 3), then ``model.from_features``."""
    B, V = images.shape[:2]
    xf = resnet50_int8_infer(qparams, images.reshape((B * V,) + images.shape[2:]),
                             act_scales=act_scales, int8_stages=int8_stages
                             ).reshape(B, V, -1)
    return model.from_features(xf, bb, init_position)


class Int8Inference:
    """Model-like shim whose ``apply`` runs any family's eval forward
    through the int8 trunk: quantizes the model's trunk and calibrates it on
    ``sample_images`` (N, H, W, 3) once, then takes single-view
    (B, H, W, 3) or view-folded (B, V, H, W, 3) images. A per-drone model
    (``trunk0``/``trunk1``, the ``_sep`` family) has each trunk quantized
    and calibrated on its own, on the same sample images, and view v's
    crops go through trunk v. ``qparams`` and ``act_scales`` hold one entry
    per trunk."""

    def __init__(self, model, sample_images: torch.Tensor, int8_stages=(1, 2, 3, 4)):
        self.model = model
        self.int8_stages = tuple(int8_stages)
        self.sep = hasattr(model, "trunk0")
        trunks = (model.trunk0, model.trunk1) if self.sep else (model.trunk,)
        self.qparams = [quantize_trunk_params(t.state_dict()) for t in trunks]
        self.act_scales = [calibrate_act_scales(qp, sample_images) for qp in self.qparams]

    def _infer(self, t: int, images: torch.Tensor) -> torch.Tensor:
        """Trunk ``t`` over images (..., H, W, 3) → (..., 2048)."""
        lead = images.shape[:-3]
        xf = resnet50_int8_infer(self.qparams[t], images.reshape((-1,) + images.shape[-3:]),
                                 act_scales=self.act_scales[t], int8_stages=self.int8_stages)
        return xf.reshape(lead + (-1,))

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        if self.sep:
            return torch.stack([self._infer(v, images[:, v]) for v in (0, 1)], dim=1)
        return self._infer(0, images)

    @torch.no_grad()
    def apply(self, images: torch.Tensor, *args, iters: Optional[int] = None,
              train: bool = False):
        if train:
            raise ValueError("the int8 trunk is inference-only")
        return self.model.from_features(self._features(images), *args, iters=iters)

    def clip_report(self, images: torch.Tensor) -> Dict[str, float]:
        """``calibration_clip_rates`` of ``images`` under this shim's scales,
        merged over the trunks under ``trunk{v}/`` keys for a per-drone model."""
        def rates(t, x):
            return calibration_clip_rates(self.qparams[t], self.act_scales[t],
                                          x.reshape((-1,) + x.shape[-3:]),
                                          int8_stages=self.int8_stages)
        if not self.sep:
            return rates(0, images)
        return {f"trunk{v}/{k}": r for v in (0, 1) for k, r in rates(v, images[:, v]).items()}
