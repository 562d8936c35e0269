"""Percent of its roofline that the backbone's attention reaches in
Multi-HMR's cell: the QKᵀ and AV operations of every block of every frame
of a call (4 · T² · C a block a frame, ``roofline.multihmr.attention_ops``)
at the bf16 dense peak, over the device time a call of the operations
launched inside the ``attention`` spans (models/vit.py's
``Attention.forward``: the flash kernel)."""

from benchmark.layer_metrics._common import span_ms
from benchmark.roofline import multihmr, peaks


def read(r):
    ms = span_ms(r, "attention")
    if ms is None:
        return None
    cfg = r.ctx.cfg
    ops = multihmr.attention_ops(cfg, r.ctx.sizes["batch"] * cfg["views"])
    return 100.0 * peaks.least_seconds({"bf16": ops}) / (ms / 1e3)
