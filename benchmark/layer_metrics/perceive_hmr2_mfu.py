"""Percent of the chip's peak that a whole HMR 2.0 perception call reaches:
the least time of its required multiply-adds (the backbone at the bf16
peak, ``roofline.vit.backbone_macs``; the decoder and SMPL in float32,
``roofline.vit.head_macs`` and ``roofline.step.smplx_macs``) over the
measured window's time a call."""

from benchmark.layer_metrics._common import mfu
from benchmark.roofline import step, vit


def read(r):
    cfg = r.ctx.cfg
    crops = r.ctx.sizes["batch"] * cfg["views"]
    return mfu(r, {"bf16": 2.0 * crops * vit.backbone_macs(cfg["backbone"]),
                   "fp32": 2.0 * crops * (vit.head_macs(cfg) + step.smplx_macs(cfg["smplx"]))})
