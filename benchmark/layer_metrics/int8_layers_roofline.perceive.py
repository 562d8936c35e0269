"""Percent of its roofline that the int8 trunk's ``int8_layers`` span
(ops/int8_trunk.py) reaches: the least time its work needs at 2·B crops
(the input's quantization, the 52 int8 convolutions with their epilogues,
the global average pool; ``roofline.resnet.int8_layers``), the larger of its
operations over the int8 peak and its bytes over the bandwidth, over the
device time a call of the operations launched inside the span."""

from benchmark.layer_metrics._common import span_ms
from benchmark.roofline import peaks, resnet


def read(r):
    ms = span_ms(r, "int8_layers")
    if ms is None:
        return None
    s, cfg = r.ctx.sizes, r.ctx.cfg
    ops, n_bytes = resnet.int8_layers(cfg["trunk"], s["crop"], s["batch"] * cfg["views"])
    return 100.0 * peaks.least_seconds({"int8": ops}, n_bytes) / (ms / 1e3)
