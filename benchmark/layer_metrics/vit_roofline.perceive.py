"""Percent of its roofline that HMR 2.0's backbone (the ``vit`` span,
models/vit.py) reaches: the least time its work needs at 2·B crops
(``roofline.vit.vit``: the patch convolution, the blocks' linears and
attention products at the bf16 dense peak, or its bytes over the bandwidth
if longer) over the device time a call of the operations launched inside
the span."""

from benchmark.layer_metrics._common import span_ms
from benchmark.roofline import peaks, vit


def read(r):
    ms = span_ms(r, "vit")
    if ms is None:
        return None
    s, cfg = r.ctx.sizes, r.ctx.cfg
    ops, n_bytes = vit.vit(cfg, s["batch"] * cfg["views"])
    return 100.0 * peaks.least_seconds({"bf16": ops}, n_bytes) / (ms / 1e3)
