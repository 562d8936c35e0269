"""Each cell at its full size on the card: a short window, ``correct``
true. Skips without a CUDA device (run on the card with
``python -m pytest benchmark/tests -m cuda``)."""

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name):
    c = harness.cell(name)
    ctx = harness.Context(cell=c, seed=2**31 + 99, device=torch.device("cuda", 0),
                          sizes=harness.sizes(c))
    r = harness.run(ctx, 2.0, False, 0.0)
    assert r["correct"], r["checks"]
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
