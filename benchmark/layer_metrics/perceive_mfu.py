"""Percent of the chip's peak that a whole perception call reaches: the
least time of its required multiply-adds (``roofline.step.perceive_ops``:
the int8 residual stages at the int8 peak, the stem in bf16, IEF and
SMPL-X in float32) over the measured window's time a call."""

from benchmark.layer_metrics._common import mfu
from benchmark.roofline import step


def read(r):
    s = r.ctx.sizes
    return mfu(r, step.perceive_ops(r.ctx.cfg, s["batch"], s["trunk"]))
