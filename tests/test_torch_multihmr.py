"""Multi-HMR in the port (models/vit.py's DINOv2 variant, models/multihmr.py,
the whole-body ``smplx_forward``, perception.perceive_multihmr) against the
benchmark's plain float32 reference (benchmark/reference/multihmr.py) on
seeded random weights, at a small size on the CPU: width 64, 2 blocks of 4
heads over a 112² frame (an 8×8 grid of 14² patches and the CLS token), a
5² stored position embedding, a 2-layer head of width 32, 0-3 persons an
image, a synthetic SMPL-X of 300 vertices with 10 expression directions.

The reference's weights maker draws zero biases and LayerNorms at 1 and 0;
the tests move every bias and LayerNorm parameter off those values so that
each parameter the port reads counts. With the backbone in float32 the
port and the reference differ only in the order of float32 sums (fused
attention against explicit softmax, one concatenated blend-shape product
against two): 1e-4 relative bounds leave two orders of magnitude. In bf16
the backbone rounds every linear's operands to 8 bits of mantissa: 3e-2
relative.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from airpose_tpu_torch.bodymodel import smplx_forward
from airpose_tpu_torch.bodymodel import lbs as lbs_mod
from airpose_tpu_torch.geometry.projection import backproject
from airpose_tpu_torch.geometry.rotations import batch_rodrigues
from airpose_tpu_torch.models import MODEL_REGISTRY, MultiHMR, family_init_args
from airpose_tpu_torch.models.multihmr import MultiHMRConfig, persons_at, persons_from_centres
from airpose_tpu_torch.models.vit import ViTConfig
from airpose_tpu_torch.perception import perceive_multihmr
from benchmark.drivers import program_body
from benchmark.drivers.perceive_multihmr import unmasked
from benchmark.reference import multihmr as ref

S, V, REL = 112, 300, 1e-4
CFG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                  / "multihmr_vitl896.json").read_text())
CFG["backbone"].update(img_size=[S, S], width=64, depth=2, heads=4, head_dim=16, pos_grid=5,
                       grid=8, patches=64, tokens=65)
CFG["detection"]["hidden"] = 64
CFG["head"].update(dim=32, heads=2, dim_head=8, mlp_dim=48, context_dim=64 + 99)
PORT_CFG = MultiHMRConfig(
    vit=ViTConfig(img_size=(S, S), patch=14, width=64, depth=2, heads=4, padding=0,
                  dinov2_grid=5),
    head_dim=32, xat_heads=2, xat_dim_head=8, xat_mlp_dim=48)
K = torch.tensor([[120.0, 0.0, 56.0], [0.0, 118.0, 57.0], [0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def weights(seed=3):
    sd = ref.make_state(CFG, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("bias") or "norm" in k:
            v.add_(0.1 * torch.randn(v.shape, generator=g))
    return sd


def port_model(sd, dtype=torch.float32):
    model = MultiHMR(dtype=dtype, cfg=PORT_CFG)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def frames(B=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, 2, S, S, 3), generator=g, dtype=torch.uint8)


def intr(B=2):
    k = K.clone().expand(B, 2, 3, 3).clone()
    k[:, 1, 0, 0] = 131.0       # the two drones' cameras differ
    return k


def body():
    return ref.make_body(7, V, "cpu")


# images 0..3 (frame · 2 + view): 2, 0, 3 and 1 persons at these patches
IMAGE = torch.tensor([0, 0, 2, 2, 2, 3])
PATCH = torch.tensor([9, 50, 0, 27, 63, 36])


def persons(image=IMAGE, patch=PATCH, n=4):
    return persons_at(image, patch, n)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_state_dict_layout_is_the_references():
    """The port's module tree has exactly the keys and shapes the
    reference's maker draws."""
    want = {k: v.shape for k, v in MultiHMR(cfg=PORT_CFG).state_dict().items()}
    assert want == {k: v.shape for k, v in ref.make_state(CFG, 0, "cpu").items()}
    assert "backbone.encoder.blocks.1.ls2.gamma" in want
    assert want["backbone.encoder.pos_embed"] == (1, 26, 64)
    assert "x_attention_head.transformer.layers.1.1.fn.to_kv.weight" in want


@pytest.mark.parametrize("dtype,bound", [(torch.float32, REL), (torch.bfloat16, 3e-2)])
def test_backbone_tokens_match_reference(dtype, bound):
    sd = weights()
    x = frames().flatten(0, 1)
    model = port_model(sd, dtype)
    with torch.no_grad():
        got = model.backbone(model.normalise(x))
        want = ref.backbone(sd, CFG, x)
    assert got.dtype == torch.float32 and got.shape == (4, 65, 64)
    assert rel(got, want) < bound


def test_position_embedding_interpolated_once():
    """The stored 5² grid is resized to the 8² patch grid once for the
    weights held, and again after a write to ``pos_embed``."""
    model = port_model(weights()).backbone.encoder
    first = model.grid_pos()
    assert first.shape == (1, 64, 64) and model.grid_pos() is first
    with torch.no_grad():
        model.pos_embed.mul_(2.0)
    second = model.grid_pos()
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first, rtol=1e-6, atol=1e-6)


def test_forward_matches_reference():
    """The whole call at the given centres: score map, every person's
    body-frame vertices, translation and 2D joints, against the reference's
    tail on the reference's own tokens (float32 backbone)."""
    sd, bd = weights(), body()
    model = port_model(sd)
    x, k = frames(), intr()
    with torch.no_grad():
        out = perceive_multihmr(model, program_body(bd), x, k, persons())
        tokens = ref.backbone(sd, CFG, x.flatten(0, 1))
        v, j, t, s = ref.perceive_tail(sd, CFG, bd, tokens, k.flatten(0, 1), IMAGE, PATCH)
    assert out.vertices.shape == (6, V, 3) and out.j2d.shape == (6, 127, 2)
    assert out.index.tolist() == [[0, 0], [0, 0], [1, 0], [1, 0], [1, 0], [1, 1]]
    assert rel(out.scores.flatten(0, 1), s) < REL
    assert rel(out.vertices - out.trans[:, None], v) < REL
    assert rel(out.trans, t) < REL
    assert float((out.j2d - j).abs().max()) < 1e-3       # pixels, at ~100 px
    # the 2D joints are the camera-frame joints through each person's own camera
    assert not torch.allclose(out.j2d[-1], j[0])


def test_detection_nms_and_threshold():
    """Planted score weights make the score a function of one channel of
    each patch token: NMS keeps the local maxima above the threshold, and
    the persons it finds give the same outputs as the same persons given as
    centres."""
    model = port_model(weights())
    C = 64
    with torch.no_grad():
        model.mlp_classif[0].weight.copy_(torch.eye(C))
        model.mlp_classif[0].bias.zero_()
        model.mlp_classif[2].weight.zero_()
        model.mlp_classif[2].weight[0, 0] = 10.0
        model.mlp_classif[2].bias.fill_(-5.0)
    tokens = torch.zeros(3, 65, C)
    grid = tokens[:, 1:, 0].view(3, 8, 8)
    grid[0, 2, 3], grid[0, 2, 4], grid[0, 3, 3] = 1.0, 0.8, 0.9   # one peak, two neighbours
    grid[0, 6, 6] = 0.7                                            # a second peak
    grid[1, 0, 7] = 0.3                                            # under the threshold
    grid[2, 5, 1] = grid[2, 5, 3] = 0.9                            # two apart: both kept
    with torch.no_grad():
        scores, found, uv = model.detect(tokens)
    assert found.image.tolist() == [0, 0, 2, 2]
    assert found.patch.tolist() == [2 * 8 + 3, 6 * 8 + 6, 5 * 8 + 1, 5 * 8 + 3]
    assert found.slot.tolist() == [0, 1, 0, 1] and (found.count, found.slots) == (4, 2)
    assert float(scores[0, 2, 3]) == pytest.approx(torch.sigmoid(torch.tensor(5.0)).item())
    assert ((uv // 14).long().tolist()
            == [[3, 2], [6, 6], [1, 5], [3, 5]])                   # (col, row) of each
    with torch.no_grad():
        given = model.detect(tokens, persons_at(found.image, found.patch, 3))
    assert torch.equal(given[2], uv)
    bd, x, k = program_body(body()), frames(), intr()
    with torch.no_grad():
        det = perceive_multihmr(model, bd, x, k)
        found = model.detect(model.backbone(model.normalise(x.flatten(0, 1))))[1]
        at = perceive_multihmr(model, bd, x, k, found)
    assert 0 < found.count == det.index.shape[0]
    assert torch.equal(det.vertices, at.vertices) and torch.equal(det.index, at.index)


def test_ragged_persons_are_independent():
    """A person's outputs do not change when another image's persons, and so
    padded slots in its own image, are added; with the padding unmasked
    they do."""
    model = port_model(weights())
    bd = program_body(body())
    x, k = frames(), intr()
    few = persons(torch.tensor([0, 3]), torch.tensor([9, 36]))
    many = persons(torch.tensor([0, 2, 2, 2, 3]), torch.tensor([9, 0, 27, 63, 36]))
    with torch.no_grad():
        a = perceive_multihmr(model, bd, x, k, few)
        b = perceive_multihmr(model, bd, x, k, many)
        unmasked(model)
        c = perceive_multihmr(model, bd, x, k, many)
    assert (few.slots, many.slots) == (1, 3)
    keep = [0, 4]                     # each alone in its image, now beside two padded slots
    torch.testing.assert_close(b.vertices[keep], a.vertices, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.j2d[keep], a.j2d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(b.trans[keep], a.trans, rtol=1e-5, atol=1e-6)
    assert rel(c.vertices[keep] - c.trans[keep][:, None],
               b.vertices[keep] - b.trans[keep][:, None]) > 1e-3


def test_images_without_persons():
    """Images 1 and 3 hold no person; a call with no person at all returns
    empty outputs and the score map."""
    model = port_model(weights())
    bd = program_body(body())
    x, k = frames(), intr()
    p = persons(torch.tensor([0, 2]), torch.tensor([9, 0]))
    with torch.no_grad():
        out = perceive_multihmr(model, bd, x, k, p)
        none = perceive_multihmr(model, bd, x, k, persons(torch.zeros(0, dtype=torch.int64),
                                                          torch.zeros(0, dtype=torch.int64)))
    assert out.index.tolist() == [[0, 0], [1, 0]] and bool(torch.isfinite(out.vertices).all())
    assert none.vertices.shape == (0, V, 3) and none.j2d.shape == (0, 127, 2)
    assert none.trans.shape == (0, 3) and none.index.shape == (0, 2)
    torch.testing.assert_close(none.scores, out.scores)


def test_centres_pick_their_patches():
    uv = torch.tensor([[14.0 * 3 + 2, 14.0 * 1 + 13], [111.9, 0.0], [0.0, 111.9]])
    p = persons_from_centres(uv, torch.tensor([0, 0, 1]), 2, 14, 8)
    assert p.patch.tolist() == [1 * 8 + 3, 7, 7 * 8] and p.slot.tolist() == [0, 1, 0]
    assert (p.count, p.slots) == (3, 2)


def test_counters_and_attention_calls():
    model = port_model(weights())
    with torch.no_grad():
        perceive_multihmr(model, program_body(body()), frames(), intr(), persons())
    assert (model.persons, model.query_slots) == (6, 4 * 3)
    assert model.attention_calls == 2 + 2 * 2


def test_whole_body_smplx_matches_reference():
    """Jaw, both hands and the expression posed: the port's SMPL-X (plain
    skinning on the CPU) against the reference's."""
    bd = body()
    g = torch.Generator().manual_seed(11)
    P = 3
    betas, expr = torch.randn(P, 10, generator=g), torch.randn(P, 10, generator=g)
    rot = batch_rodrigues(0.3 * torch.randn(P, 53, 3, generator=g))
    got = smplx_forward(program_body(bd), betas, rot[:, 1:22], rot[:, :1], jaw_pose=rot[:, 22:23],
                        hand_pose=rot[:, 23:], expression=expr)
    v, j = ref.smplx(bd, betas, expr, rot)
    assert rel(got.vertices, v) < REL and rel(got.joints, j) < REL
    plain = smplx_forward(program_body(bd), betas, rot[:, 1:22], rot[:, :1])
    assert rel(plain.vertices, v) > 1e-2     # hands, jaw and expression move the body


def smplx_forward_before(params, betas, body_pose, global_orient):
    """``smplx_forward`` as it was before it took the jaw, hands and
    expression: the oracle of the body-only call."""
    B = betas.shape[0]
    dtype = betas.dtype
    jaw_eyes = torch.eye(3, dtype=dtype).expand(B, 3, 3, 3)
    hands = params.hand_pose.to(dtype).expand((B,) + params.hand_pose.shape)
    full = lbs_mod.full_pose_from_parts(global_orient, body_pose, jaw_eyes, hands, pose2rot=False)
    verts, posed = lbs_mod.lbs(betas, full, params.v_template, params.shape_dirs,
                               params.pose_dirs, params.j_regressor, params.parents,
                               params.lbs_weights)
    extra = verts[:, params.extra_joint_ids]
    lmk = torch.einsum("blvc,lv->blc", verts[:, params.lmk_vert_ids], params.lmk_bary)
    return verts, torch.cat([posed, extra, lmk], dim=1)


def test_body_only_smplx_is_bit_identical():
    """Without jaw, hands and expression the forward is the body-only one,
    bit for bit, whether the model has expression directions or not; the
    whole-body call at the identity jaw, the mean hands and no expression
    agrees with it."""
    bd = program_body(body())
    g = torch.Generator().manual_seed(12)
    betas = torch.randn(4, 10, generator=g)
    rot = batch_rodrigues(0.3 * torch.randn(4, 22, 3, generator=g))
    want = smplx_forward_before(bd, betas, rot[:, 1:], rot[:, :1])
    for p in (bd, dataclasses.replace(bd, expr_dirs=None)):
        got = smplx_forward(p, betas, rot[:, 1:], rot[:, :1])
        assert torch.equal(got.vertices, want[0]) and torch.equal(got.joints, want[1])
    full = smplx_forward(bd, betas, rot[:, 1:], rot[:, :1],
                         jaw_pose=torch.eye(3).expand(4, 1, 3, 3),
                         hand_pose=bd.hand_pose.expand(4, 30, 3, 3),
                         expression=torch.zeros(4, 10))
    torch.testing.assert_close(full.vertices, want[0], rtol=1e-5, atol=1e-6)


def test_backproject_and_projection_round_trip():
    uv = torch.tensor([[10.0, 20.0], [100.0, 3.0]])
    k = K.expand(2, 3, 3)
    p = backproject(uv, torch.tensor([8.0, 12.0]), k)
    assert p[:, 2].tolist() == [8.0, 12.0]
    back = p[:, :2] / p[:, 2:] * torch.stack([k[:, 0, 0], k[:, 1, 1]], -1) + k[:, :2, 2]
    torch.testing.assert_close(back, uv)


def test_registry_and_init_args():
    assert MODEL_REGISTRY["multihmr"] is MultiHMR
    model = MultiHMR(cfg=PORT_CFG, dtype=torch.float32)
    img, k = family_init_args("multihmr", 2, S, "cpu")
    assert img.shape == (2, S, S, 3) and k.shape == (2, 3, 3)
    with torch.no_grad():
        out = model(img, k, persons_at(torch.tensor([1]), torch.tensor([5]), 2))
    assert out.pose6d.shape == (1, 318) and out.scores.shape == (2, 8, 8)
    assert out.depth.shape == (1,) and bool((out.depth > 0).all())
