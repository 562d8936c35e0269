"""HMR 2.0 in the port (models/vit.py, models/hmr2.py, bodymodel/smpl.py,
perception.perceive_hmr2) against the benchmark's plain float32 reference
(benchmark/reference/hmr2.py) on seeded random weights, at a small size on
the CPU: width 64, 2 blocks of 4 heads over a 64×48 view of 64² crops (12
tokens), a 2-layer decoder, a synthetic SMPL of 300 vertices.

The reference's weights maker draws the published initialisation, with zero
biases and LayerNorms at 1 and 0; the tests move every bias and LayerNorm
parameter off those values so that each parameter the port reads counts.
With the backbone in float32 the port and the reference differ only in the
order of float32 sums (fused attention against explicit softmax): 1e-4
relative bounds leave two orders of magnitude. In bf16 the backbone rounds
every linear's operands to 8 bits of mantissa: 3e-2 relative.
"""

import numpy as np
import pytest
import torch

from airpose_tpu_torch.bodymodel import (SMPLParams, cuda_lbs, smpl_forward, smplx_forward,
                                         synthetic_smpl_params, synthetic_smplx_params)
from airpose_tpu_torch.bodymodel.smpl import SMPL_PARENTS
from airpose_tpu_torch.bodymodel.smplx import SMPLX_PARENTS
from airpose_tpu_torch.geometry.rotations import batch_rodrigues
from airpose_tpu_torch.models import MODEL_REGISTRY, HMR2, family_init_args
from airpose_tpu_torch.models.hmr2 import DecoderConfig, pose_rotmats
from airpose_tpu_torch.models.vit import ViTConfig
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.perception import cam_crop_to_full, perceive_hmr2
from benchmark.inputs import perception_pool
from benchmark.reference import hmr2 as ref
from benchmark.reference import smplx as ref_smplx

CROP, V, B = 64, 300, 2
CFG = {
    "views": 2, "crop": CROP,
    "backbone": {"img_size": [64, 48], "patch": 16, "padding": 2, "width": 64, "depth": 2,
                 "heads": 4, "mlp_ratio": 4, "tokens": 12},
    "head": {"dim": 32, "depth": 2, "heads": 2, "dim_head": 8, "mlp_dim": 48,
             "context_dim": 64, "token_dim": 1},
    "outputs": {"decpose": 144, "decshape": 10, "deccam": 3},
}
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_configs(cfg):
    vb, hd = cfg["backbone"], cfg["head"]
    return (ViTConfig(img_size=tuple(vb["img_size"]), patch=vb["patch"], width=vb["width"],
                      depth=vb["depth"], heads=vb["heads"], mlp_ratio=vb["mlp_ratio"],
                      padding=vb["padding"]),
            DecoderConfig(dim=hd["dim"], depth=hd["depth"], heads=hd["heads"],
                          dim_head=hd["dim_head"], mlp_dim=hd["mlp_dim"],
                          context_dim=hd["context_dim"]))


def weights(seed=3):
    sd = ref.make_state(CFG, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("bias") or "norm" in k:
            v.add_(0.1 * torch.randn(v.shape, generator=g))
    return sd


def port_model(sd, dtype=torch.float32):
    vit, dec = port_configs(CFG)
    model = HMR2(dtype=dtype, vit=vit, decoder=dec)
    model.load_state_dict(sd, strict=True)
    return model


def crops(seed=5, batches=1):
    return perception_pool(seed, batches, B, CROP, "cpu")


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def body():
    return ref.make_smpl(7, V, "cpu")


def test_state_dict_layout_is_the_published_one():
    """The port's module tree has exactly the keys and shapes the
    reference's maker draws (the published checkpoint's layout)."""
    vit, dec = port_configs(CFG)
    want = {k: v.shape for k, v in HMR2(vit=vit, decoder=dec).state_dict().items()}
    assert want == {k: v.shape for k, v in ref.make_state(CFG, 0, "cpu").items()}
    assert "smpl_head.transformer.transformer.layers.1.1.fn.to_kv.weight" in want
    assert "smpl_head.transformer.transformer.layers.0.0.fn.to_qkv.bias" not in want
    assert "backbone.blocks.1.attn.qkv.bias" in want


@pytest.mark.parametrize("dtype,bound", [(torch.float32, REL), (torch.bfloat16, 3e-2)])
def test_backbone_tokens_match_reference(dtype, bound):
    sd = weights()
    x = crops()[0]["images"].flatten(0, 1)
    with torch.no_grad():
        model = port_model(sd, dtype)
        got = model.backbone(model.crop_columns(x))
        want = ref.backbone(sd, CFG, x)
    assert got.dtype == torch.float32 and got.shape == (2 * B, 12, 64)
    assert rel(got, want) < bound
    # the residual stream is token-major (a channel-major one costs every
    # LayerNorm a copy on the card)
    assert model.backbone.patch_embed(model.crop_columns(x).to(dtype)).is_contiguous()


def test_head_matches_reference():
    sd = weights()
    tokens = torch.randn(2 * B, 12, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = port_model(sd).smpl_head(tokens)
        want = ref.head(sd, CFG, tokens)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, w) < REL


def test_6d_layout_is_hmr2s():
    """pose_rotmats reads (a1, a2) one column after the other, as HMR 2.0's
    rot6d_to_rotmat does."""
    x = torch.randn(5, 24 * 6, generator=torch.Generator().manual_seed(4))
    got = pose_rotmats(x)
    want = ref.rot6d_to_rotmat(x.reshape(5, 24, 6))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[..., 0], torch.nn.functional.normalize(
        x.reshape(5, 24, 6)[..., :3], dim=-1))


def random_rotations(n, seed):
    g = torch.Generator().manual_seed(seed)
    return batch_rodrigues(torch.randn(n, 24, 3, generator=g) * 0.4)


def test_smpl_matches_reference():
    b = body()
    params = SMPLParams(**b)
    rot = random_rotations(3, 1)
    betas = torch.randn(3, 10, generator=torch.Generator().manual_seed(8))
    got = smpl_forward(params, betas, rot[:, 1:], rot[:, :1])
    want_v, want_j = ref.smpl(b, betas, rot)
    assert got.vertices.shape == (3, V, 3) and got.joints.shape == (3, 45, 3)
    assert rel(got.vertices, want_v) < 1e-5
    assert rel(got.joints, want_j) < 1e-5


def test_smpl_schema():
    """SMPL's own tree (the hands on the wrists, where SMPL-X has the jaw and
    eyes), 24 joints, 207 pose blend shapes, the published vertex picks at
    6,890 vertices."""
    assert SMPL_PARENTS[:22] == SMPLX_PARENTS[:22]
    assert SMPL_PARENTS[22:] == (20, 21) and SMPLX_PARENTS[22:24] == (15, 15)
    p = synthetic_smpl_params(seed=1)
    assert p.v_template.shape == (6890, 3) and p.pose_dirs.shape == (207, 6890 * 3)
    assert p.j_regressor.shape == (24, 6890) and p.lbs_weights.shape == (6890, 24)
    assert p.extra_joint_ids.tolist()[:5] == [332, 6260, 2800, 4071, 583]
    assert torch.allclose(p.lbs_weights.sum(1), torch.ones(6890))
    small = synthetic_smpl_params(num_vertices=V, seed=1)
    assert int(small.extra_joint_ids.max()) < V
    assert torch.equal(small.v_template, synthetic_smpl_params(num_vertices=V, seed=1).v_template)


def test_cam_crop_to_full_matches_reference():
    pool = crops()[0]
    cam = torch.randn(B, 2, 3, generator=torch.Generator().manual_seed(6)) * 0.3 + torch.tensor(
        [0.9, 0.0, 0.0])
    got = cam_crop_to_full(cam, pool["bb"], pool["intr"], 256)
    want = ref.cam_crop_to_full(cam, pool["bb"], pool["intr"], 256)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)   # (bb·pp against (bb + 1)·pp − pp)
    # a box centred on the principal point leaves (tx, ty) as the camera has them
    bb = torch.tensor([[[0.0, 0.0, 0.5]] * 2] * B)
    t = cam_crop_to_full(cam, bb, pool["intr"], 256)
    torch.testing.assert_close(t[..., :2], cam[..., 1:])
    torch.testing.assert_close(t[..., 2], 2 * 1475.0 / (512 * cam[..., 0]))


def test_perceive_hmr2_matches_reference():
    sd, b = weights(), body()
    model = port_model(sd)
    for pool in crops(batches=2):
        verts, j2d = perceive_hmr2(model, SMPLParams(**b), pool["images"], pool["bb"],
                                   pool["intr"])
        with torch.no_grad():
            tokens = ref.backbone(sd, CFG, pool["images"].flatten(0, 1))
            want_v, want_j = ref.perceive_tail(sd, CFG, b, tokens.reshape(B, 2, 12, 64),
                                               pool["bb"], pool["intr"], CROP)
        assert verts.shape == (B, 2, V, 3) and j2d.shape == (B, 2, 45, 2)
        assert rel(verts, want_v) < REL
        assert rel(j2d, want_j) < REL


def test_views_are_regressed_one_by_one():
    """HMR 2.0 has no exchange between views: a frame's view 1 gives what it
    gives alone."""
    sd, b = weights(), body()
    model, pool = port_model(sd), crops()[0]
    verts, _ = perceive_hmr2(model, SMPLParams(**b), pool["images"], pool["bb"], pool["intr"])
    swapped = pool["images"].flip(1)
    verts_s, _ = perceive_hmr2(model, SMPLParams(**b), swapped, pool["bb"], pool["intr"])
    torch.testing.assert_close(verts_s, verts.flip(1), atol=1e-6, rtol=1e-6)


def test_spans_open_and_attention_calls_counted():
    from torch.profiler import ProfilerActivity, profile

    model, pool = port_model(weights()), crops()[0]
    before = model.attention_calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        perceive_hmr2(model, synthetic_smpl_params(num_vertices=V), pool["images"], pool["bb"],
                      pool["intr"])
    names = {e.name for e in prof.events()}
    assert {"vit", "patch_embed", "vit_blocks", "hmr2_head", "smpl", "project"} <= names
    assert model.attention_calls - before == 2 + 2 * 2


def test_attention_calls_at_the_published_depths():
    """32 backbone blocks and 6 decoder layers (self and cross) make 44
    attention calls a forward; widths kept small for the CPU."""
    vit = ViTConfig(img_size=(32, 16), width=16, heads=2)
    dec = DecoderConfig(dim=16, heads=2, dim_head=8, mlp_dim=16, context_dim=16)
    assert vit.depth == 32 and dec.depth == 6
    model = HMR2(dtype=torch.float32, vit=vit, decoder=dec)
    with torch.no_grad():
        model(torch.zeros(2, 32, 32, 3))
        assert model.attention_calls == 44
        model(torch.zeros(1, 32, 32, 3))
    assert model.attention_calls == 88


def test_published_sizes():
    """ViT-H/16 at 256×192: 16×12 = 192 tokens of 1,280, 16 heads of 80;
    the decoder reads them at 1,024 with 8 heads of 64."""
    vit, dec = ViTConfig(), DecoderConfig()
    assert vit.grid == (16, 12) and vit.tokens == 192
    assert vit.width // vit.heads == 80 and vit.mlp_ratio * vit.width == 5120
    assert (dec.dim, dec.depth, dec.heads * dec.dim_head, dec.context_dim) == (1024, 6, 512, 1280)


def test_registry_and_init_args():
    assert MODEL_REGISTRY["hmr2"] is HMR2
    (x,) = family_init_args("hmr2", 3, device="cpu")
    assert x.shape == (3, 256, 256, 3)
    assert family_init_args("hmr", 1, device="cpu")[0].shape == (1, 224, 224, 3)


def test_smplx_path_unchanged():
    """SMPL-X keeps its 55-joint tree and agrees with the plain reference."""
    p = synthetic_smplx_params(num_vertices=V)
    assert p.parents == SMPLX_PARENTS and len(p.parents) == 55
    g = torch.Generator().manual_seed(9)
    betas = torch.randn(2, 10, generator=g)
    pose = batch_rodrigues(torch.randn(2, 21, 3, generator=g) * 0.3)
    eye = torch.eye(3).expand(2, 1, 3, 3)
    got = smplx_forward(p, betas, pose, eye)
    want = ref_smplx.forward({
        "v_template": p.v_template, "shape_dirs": p.shape_dirs, "pose_dirs": p.pose_dirs,
        "j_regressor": p.j_regressor, "lbs_weights": p.lbs_weights, "hand_pose": p.hand_pose,
        "extra_joint_ids": p.extra_joint_ids, "lmk_vert_ids": p.lmk_vert_ids,
        "lmk_bary": p.lmk_bary}, betas, pose, eye)
    assert rel(got.vertices, want[0]) < 1e-5 and rel(got.joints, want[1]) < 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the skinning kernel has no CPU mode)")


@pytest.mark.cuda
def test_skinning_kernel_at_smpl_shape(cuda):
    """The skinning kernel at SMPL's J = 24, V = 6,890 (128 bodies) against
    its plain version, within the kernel's own bound (tests/test_torch_lbs.py)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    p = synthetic_smpl_params().to("cuda")
    rel_tf = torch.eye(4, device="cuda").repeat(128, 24, 1, 1)
    rel_tf[:, :, :3] += 0.1 * torch.randn(128, 24, 3, 4, generator=g, device="cuda")
    v = torch.randn(128, 6890, 3, generator=g, device="cuda")
    before = _build.counts["lbs_skinning"]
    got = cuda_lbs.skinning(p.lbs_weights, rel_tf, v)
    assert _build.counts["lbs_skinning"] == before + 1
    want = cuda_lbs.skinning_reference(p.lbs_weights, rel_tf, v)
    assert float((got - want).abs().max()) < 2e-5 * max(1.0, float(want.abs().max()))
    assert np.isfinite(got.cpu().numpy()).all()
