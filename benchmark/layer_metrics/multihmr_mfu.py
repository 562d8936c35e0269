"""Percent of the chip's peak that a whole Multi-HMR perception call
reaches: the least time of its required operations at the peaks of their
precisions (``roofline.multihmr.call_ops``: the backbone with its attention
products at the bf16 peak; detection, the head on the real persons only and
SMPL-X per person at the float32 peak), averaged over the calls of the
measured window (which cycle through the pool's batches from the first),
over the measured window's time a call."""

from benchmark.drivers.perceive_multihmr import person_counts
from benchmark.layer_metrics._common import mfu
from benchmark.roofline import multihmr


def read(r):
    cfg, n = r.ctx.cfg, r.window.units
    pool = person_counts(r.ctx)
    ops = {"bf16": 0.0, "fp32": 0.0}
    for i in range(n):
        for k, v in multihmr.call_ops(cfg, pool[i % len(pool)]).items():
            ops[k] += v / n
    return mfu(r, ops)
