"""Device ms a perception call of the operations launched inside
Multi-HMR's ``hph`` span (perception.perceive_multihmr): the Human
Prediction Head over every person of the call (the camera embedding, the
padded query slots, two self- and cross-attention blocks, the readouts)."""

from benchmark.layer_metrics._common import span_ms


def read(r):
    return span_ms(r, "hph")
