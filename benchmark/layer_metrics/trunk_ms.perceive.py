"""Device ms a perception call of the operations launched inside the
chain's ``trunk`` span (perception.py): the whole ResNet-50 of 2·B crops."""

from benchmark.layer_metrics._common import span_ms


def read(r):
    return span_ms(r, "trunk")
