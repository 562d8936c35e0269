"""Percent of the chip's peak that a whole training step reaches: the least
time of its required multiply-adds (``roofline.step.train_ops``: the trunk's
forward and backward in its dtype, IEF and SMPL-X in float32) over the
measured window's time a step."""

from benchmark.layer_metrics._common import mfu
from benchmark.roofline import step


def read(r):
    return mfu(r, step.train_ops(r.ctx.cfg, r.ctx.sizes["batch"]))
