"""Device ms a training step of the operations launched inside the train
step's ``optimizer`` span (AMSGrad's update, train/loop.py)."""

from benchmark.layer_metrics._common import span_ms


def read(r):
    return span_ms(r, "optimizer")
