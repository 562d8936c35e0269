"""Multi-HMR on the card at its published sizes (DINOv2 ViT-L/14 over 896²
frames, the 2-block head, SMPL-X of 10,475 vertices with the skinning
kernel): the forward on one two-view frame against the plain float32
reference (benchmark/reference/multihmr.py), the LayerScale norm points'
launches, and the persons' counters. Every test is marked ``cuda`` and
skips without a card. Imports neither JAX nor airpose_tpu, so on a machine
with a card

  python -m pytest tests/test_torch_multihmr_cuda.py --noconftest -q
"""

import json
from pathlib import Path

import pytest
import torch

from airpose_tpu_torch.models.multihmr import persons_from_centres
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.perception import perceive_multihmr
from benchmark.drivers import program_body
from benchmark.drivers.perceive_multihmr import intrinsics, program_multihmr
from benchmark.reference import multihmr as ref
from benchmark.reference.model import no_tf32

CFG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                  / "multihmr_vitl896.json").read_text())
S, V = 896, 10475


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    dev = torch.device("cuda")
    sd = ref.make_state(CFG, 2**31 + 3, dev)
    model = program_multihmr(CFG, sd, dev)
    bd = ref.make_body(2**31 + 4, V, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randint(0, 256, (1, 2, S, S, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    # three persons in view 0 and one in view 1, at sub-patch offsets
    uv = torch.tensor([[100.0, 200.0], [450.5, 451.0], [890.0, 13.0], [30.0, 700.0]], device=dev)
    image = torch.tensor([0, 0, 0, 1], device=dev)
    persons = persons_from_centres(uv, image, 2, 14, 64, slots=3)
    return dev, sd, model, bd, frames, intrinsics(S, dev).expand(1, 2, 3, 3), persons


@pytest.mark.cuda
def test_forward_matches_reference_at_published_sizes(setup):
    """The program's bf16 backbone against the float32 reference's tokens;
    its float32 tail against the reference's tail on the program's
    tokens."""
    dev, sd, model, bd, frames, K, persons = setup
    seen = {}
    hook = model.backbone.register_forward_hook(lambda m, a, o: seen.update(t=o))
    try:
        out = perceive_multihmr(model, program_body(bd), frames, K, persons)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    no_tf32()
    t = seen["t"]
    with torch.no_grad():
        want = torch.cat([ref.backbone(sd, CFG, frames[0, i:i + 1]) for i in range(2)])
        v, j, tr, s = ref.perceive_tail(sd, CFG, bd, t, K[0], persons.image, persons.patch)
    assert t.shape == (2, 4097, 1024)
    assert float((t - want).norm() / want.norm()) < 0.03
    cos = torch.nn.functional.cosine_similarity(t.flatten(1), want.flatten(1), dim=1)
    assert float((1 - cos).max()) < 1e-3
    body_v = out.vertices - out.trans[:, None]
    assert float(((body_v - v).norm(dim=(1, 2)) / v.norm(dim=(1, 2))).max()) < 1e-3
    assert float((out.trans - tr).norm() / tr.norm()) < 1e-4
    assert float((out.scores.flatten(0, 1) - s).norm() / s.norm()) < 1e-4
    assert out.index.tolist() == [[0, 0], [0, 0], [0, 0], [0, 1]]
    assert out.j2d.shape == (4, 127, 2) and bool(torch.isfinite(out.j2d).all())


@pytest.mark.cuda
def test_layer_scale_norm_points_launch_once_each(setup):
    """2·24 + 1 = 49 launches of the add + LayerScale + LayerNorm kernel a
    backbone forward; each attention module runs once (24 + 2·2)."""
    dev, sd, model, bd, frames, K, persons = setup
    before = _build.counts["add_layernorm"]
    calls = model.attention_calls
    perceive_multihmr(model, program_body(bd), frames, K, persons)
    torch.cuda.synchronize()
    assert _build.counts["add_layernorm"] - before == 49
    assert model.attention_calls - calls == 24 + 2 * 2


@pytest.mark.cuda
def test_persons_and_query_slots(setup):
    """The counters: 4 real queries, 2 images of 3 slots; without persons
    given, detection's own persons."""
    dev, sd, model, bd, frames, K, persons = setup
    p0, s0 = model.persons, model.query_slots
    perceive_multihmr(model, program_body(bd), frames, K, persons)
    assert (model.persons - p0, model.query_slots - s0) == (4, 6)
    p0, s0 = model.persons, model.query_slots
    out = perceive_multihmr(model, program_body(bd), frames, K)
    found = out.index.shape[0]
    assert model.persons - p0 == found
    assert model.query_slots - s0 == 2 * max(int((out.index[:, 1] == v).sum()) for v in (0, 1))
    assert out.scores.shape == (1, 2, 64, 64)
