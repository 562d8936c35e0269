"""Device ms a perception call of the operations launched inside HMR 2.0's
``vit`` span (perception.py): the whole backbone of 2·B crops."""

from benchmark.layer_metrics._common import span_ms


def read(r):
    return span_ms(r, "vit")
