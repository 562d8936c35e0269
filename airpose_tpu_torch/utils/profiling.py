"""Profiling & step-timing utilities (port of airpose_tpu/utils/profiling.py).

``trace`` captures a ``torch.profiler`` trace of the host and, on the card,
the device, and writes it as a Chrome trace; ``sync`` is a barrier that
returns the first scalar of its tensors; ``StepTimer`` keeps rolling step
times, from CUDA events on the card (the device's time between the start
and the end of the step) and from the host clock on the CPU.
"""

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import resolve_device


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (the CPU, and CUDA where a card is present) and
    write ``log_dir/trace.json``, a Chrome trace (chrome://tracing,
    Perfetto). Yields the profiler, whose ``key_averages()`` and
    ``events()`` the caller may read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):  # NamedTuple outputs among them
        for v in tree:
            yield from _leaves(v)


def sync(tree) -> float:
    """Wait for the tensors of a nested structure (dicts, lists, tuples,
    NamedTuples) and return the first scalar of the first one as a float
    (0.0 if there is none): a synchronize of their devices, then one
    scalar read back."""
    leaves = [x for x in _leaves(tree) if x.numel()]
    if not leaves:
        return 0.0
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return float(leaves[0].reshape(-1)[0])


class StepTimer:
    """Rolling step-time statistics. On the card a step's time is the
    elapsed time between two CUDA events recorded at ``start`` and ``stop``
    on the current stream (``stop`` waits for the second); on the CPU it
    is the host clock, after ``sync`` of the step's outputs. ``device``
    is the CUDA card by default (raises without it)."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.times = []
        self.cuda = resolve_device(device).type == "cuda"
        self._t0: Optional[float] = None
        self._e0 = None

    def start(self):
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if self.cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            e1.synchronize()
            dt = self._e0.elapsed_time(e1) / 1e3
        else:
            if outputs is not None:
                sync(outputs)
            dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
