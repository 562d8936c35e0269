"""50/50 dataset mixing — the reference's `mixed_dataset`, fixed (copy of
airpose_tpu/data/mixed.py).

The reference's wrapper is declared as a 50/50 h36m/aerialpeople mix but
actually ALWAYS returns dataset[0] (ref copenet/src/copenet/dsets/
mixed_dataset.py:29 — `np.random.rand(1) < 2` is always true). This
implementation does what that code claims: each draw picks one source
with the configured probability, indices wrap modulo each source's
length. Any two datasets exposing the canonical
``host_batch(indices, rng, ...)`` contract mix; the batch comes wholly
from one source per call (sources may carry different GT fields — a
mixed-GT batch would have ragged keys)."""

from typing import Dict, Sequence

import numpy as np


def mixed_draw(rng: np.random.Generator, p_a: float = 0.5) -> int:
    """The per-batch source draw (0 with probability ``p_a``, else 1) —
    the ONE definition of the declared mixing semantics. Used both here
    and by the trainer's source factory (whose sources are finish-batch
    closures rather than dataset objects)."""
    return 0 if rng.random() < p_a else 1


class MixedDataset:
    def __init__(self, a, b, p_a: float = 0.5):
        self.a, self.b, self.p_a = a, b, float(p_a)

    def __len__(self) -> int:
        # one epoch covers the larger source once (the reference sized
        # itself on dataset[0] only)
        return max(len(self.a), len(self.b))

    def host_batch(self, indices: Sequence[int], rng: np.random.Generator,
                   **kwargs) -> Dict:
        src = (self.a, self.b)[mixed_draw(rng, self.p_a)]
        idx = [i % len(src) for i in indices]
        out = src.host_batch(idx, rng, **kwargs)
        # per-row source tag — keeps the canonical every-array-leads-with-B
        # batch layout so the batch stays shardable over a device mesh
        out["mixed_source"] = np.full(
            len(indices), 0 if src is self.a else 1, np.int32)
        return out
