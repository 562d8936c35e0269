"""Profiling utilities (port of airpose_tpu/utils/profiling.py).

``span`` names a stretch of host work in a ``torch.profiler`` trace and
costs one flag check while no profiler records; ``trace`` captures a
``torch.profiler`` trace of the host's threads and, on the card, the
device, and writes it as a Chrome trace; ``sync`` is a barrier that
returns the first scalar of its tensors.
"""

import contextlib
import os
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` span while a profiler records, else one
    shared null context: ``record_function`` enters a dispatcher op on every
    call, recording or not, and the port's spans sit on its hot paths.

    A profiler records the spans of the thread that entered it; spans
    opened on other threads (the server's event loop and executor) reach
    its trace only where it profiles every thread, as ``trace`` does."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (the host's every thread, and CUDA where a card is
    present) and write ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
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
