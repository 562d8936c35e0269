"""Shared fixtures of the benchmark's own tests (CPU, small sizes).

Run from the repository root: ``python -m pytest benchmark/tests -q``.
The tests marked ``cuda`` run a cell at its full size and skip without a
CUDA device.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = dict(batch=2, crop=64, num_vertices=300, pool_batches=4, trace_units=2,
             sampled_calls=2)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_ctx():
    """A CPU context of a cell at the tests' small sizes."""
    from benchmark import harness

    def make(name, seed=2**31 + 7, **kw):
        c = harness.cell(name)
        return harness.Context(cell=c, seed=seed, device=torch.device("cpu"),
                               sizes=harness.sizes(c, **SMALL), **kw)
    return make


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
