"""The Multi-HMR cell (``perceive_multihmr_vitl896_b8``, driver
``drivers/perceive_multihmr.py``) at a small size on the CPU: the
configuration shrunk to width 64, 2 blocks of 4 heads over a 112² frame (an
8×8 grid), a 2-layer head of width 32, 0-3 persons an image. It agrees with
the reference, and ``correct`` comes out false with each planted fault and
with the control (the next lower precision) in the program's place. Also
Multi-HMR's work counts (``roofline/multihmr.py``), by hand at the
published sizes and against the reference's own products at the small
size, and the traffic's persons."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.drivers import perceive_multihmr as drv
from benchmark.reference import multihmr as ref
from benchmark.roofline import multihmr, peaks, step, vit

CELL = "perceive_multihmr_vitl896_b8"
CFG = harness.load_json(harness.ROOT / "configs" / "multihmr_vitl896.json")
SIZES = dict(batch=2, crop=112, num_vertices=300, pool_batches=3, trace_units=2,
             sampled_calls=2, persons_mean=1.5, persons_max=3)


def small_config():
    cfg = copy.deepcopy(CFG)
    cfg["backbone"].update(img_size=[112, 112], width=64, depth=2, heads=4, head_dim=16,
                           pos_grid=5, grid=8, patches=64, tokens=65)
    cfg["detection"]["hidden"] = 64
    cfg["head"].update(dim=32, heads=2, dim_head=8, mlp_dim=48, context_dim=64 + 99)
    return cfg


@pytest.fixture
def ctx(monkeypatch):
    """A CPU context of the cell at the small sizes. The published draw (std
    0.02 whatever the width) makes a block of width 64 add about a fourth of
    what it adds at 1,024: the blocks' linears are scaled by √(1024 / 64),
    so that a block weighs in the small backbone as much as in the published
    one."""
    real = ref.make_state

    def make_state(cfg, seed, device):
        sd = real(cfg, seed, device)
        for k, v in sd.items():
            if k.startswith("backbone.encoder.blocks.") and v.ndim == 2:
                v.mul_((CFG["backbone"]["width"] / cfg["backbone"]["width"]) ** 0.5)
        return sd
    monkeypatch.setattr(ref, "make_state", make_state)

    def make(seed=2**31 + 11, **kw):
        c = harness.cell(CELL)
        c = dataclasses.replace(c, config=small_config())
        return harness.Context(cell=c, seed=seed, device=torch.device("cpu"),
                               sizes=harness.sizes(c, **SIZES), **kw)
    return make


def _run(ctx, trace=False):
    return harness.run(ctx, 0.3, trace, 0.0)


# ---- the counts --------------------------------------------------------------------

def test_vit_l_counts_by_hand():
    vb = CFG["backbone"]
    T, C = 4097, 1024
    assert multihmr.attention_macs(vb) == 2 * T * T * C
    block = 12 * T * C * C + 2 * T * T * C
    assert vit.block_macs(vb) == block
    # the patch convolution runs over the 4,096 patches, not the CLS token
    assert multihmr.backbone_macs(vb) == 4096 * 3 * 14 * 14 * C + 24 * block
    per_frame = 2.0 * multihmr.backbone_macs(vb)
    assert per_frame == pytest.approx(4.13e12, rel=0.01)
    # attention's products are 40% of the backbone's multiply-adds at 4,097 tokens
    share = vb["depth"] * multihmr.attention_macs(vb) / multihmr.backbone_macs(vb)
    assert 0.39 < share < 0.41
    assert multihmr.attention_ops(CFG, 16) == 16 * 24 * 4.0 * T * T * C
    assert multihmr.body_macs(CFG) == step.smplx_macs(CFG["smplx"]) + 10475 * 3 * 10


def test_head_counts_by_hand():
    """Two frames of one and two persons, one of none: the k and v
    projections of each frame with persons, each person's query side."""
    hd, T = CFG["head"], 4097
    D, inner, ctx_dim = 1024, 512, 1123
    q_side = lambda n: (D * 3 * inner + 2 * n * inner + inner * D  # noqa: E731
                        + D * inner + 2 * T * inner + inner * D + 2 * D * 1024)
    want = 338 * D
    for n in (1, 2):
        want += n * ctx_dim * D + hd["xat_depth"] * (T * ctx_dim * 2 * inner + n * q_side(n))
        want += n * D * (318 + 10 + 10 + 1)
    assert multihmr.head_macs(CFG, [1, 0, 2]) == want
    ops = multihmr.call_ops(CFG, [1, 0, 2])
    assert ops["bf16"] == 3 * 2.0 * multihmr.backbone_macs(CFG["backbone"])
    det = 3 * 4096 * (1024 * 1024 + 1024) + 3 * (1024 * 1024 + 2048)
    assert ops["fp32"] == 2.0 * (det + want + 3 * multihmr.body_macs(CFG))
    # a 16-frame call of 48 persons: the backbone's 66 TFLOP, the float32 rest
    # under 2% of the bf16 work's time at the peaks
    ops = multihmr.call_ops(CFG, [3] * 16)
    assert ops["bf16"] == pytest.approx(66.1e12, rel=0.01)
    assert ops["fp32"] / peaks.FP32_FLOPS < 0.5 * ops["bf16"] / peaks.BF16_FLOPS


@pytest.mark.parametrize("part", ["backbone", "head"])
def test_counts_match_the_references_products(part):
    """The multiply-adds of ``roofline/multihmr.py`` are exactly the products
    the plain reference runs (its linears, convolution and attention
    matmuls), counted by PyTorch's flop counter."""
    cfg = small_config()
    sd = ref.make_state(cfg, 0, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if part == "backbone":
            ref.backbone(sd, cfg, torch.zeros(3, 112, 112, 3))
            want = 3 * 2.0 * multihmr.backbone_macs(cfg["backbone"])
        else:
            context = torch.zeros(65, cfg["head"]["context_dim"])
            ref.head(sd, cfg, context, torch.tensor([3, 9, 40]))
            want = 2.0 * multihmr.head_macs(cfg, [3])
    assert fc.get_total_flops() == want
    params = sum(v.numel() for k, v in sd.items() if k.startswith("backbone."))
    vb = cfg["backbone"]
    C = vb["width"]
    block = 4 * C + 4 * C * C + 4 * C + 2 * 4 * C * C + 5 * C + 2 * C
    assert params == C + (26 * C) + 3 * 196 * C + C + 2 * block + 2 * C


def test_published_backbone_is_vit_l():
    """DINOv2 ViT-L/14: ~304 M parameters with its 37² + 1 position
    embeddings."""
    shapes = [s for n, s, _ in ref.model_spec(CFG) if n.startswith("backbone.")]
    n = sum(int(np.prod(s)) for s in shapes)
    assert 303e6 < n < 305e6


# ---- the traffic ----------------------------------------------------------------------

def test_person_layout():
    layout = drv.person_layout(2**31 + 5, 8, 16, 64, 3, 12)
    counts = np.array([[len(a) for a in b] for b in layout])
    assert counts.shape == (8, 16) and counts.min() >= 0 and counts.max() <= 12
    assert 2.0 < counts.mean() < 4.2 and len(set(counts.sum(1))) > 1
    for b in layout:
        for a in b:
            assert len(set(a[:, 0])) == len(a)                 # distinct patches
            assert ((a[:, 1:] > 0) & (a[:, 1:] < 1)).all()
    assert layout[0][3].tolist() == drv.person_layout(2**31 + 5, 8, 16, 64, 3, 12)[0][3].tolist()


def test_pool_persons_sit_at_their_patches(ctx):
    c = ctx()
    pool = drv.multihmr_pool(c, torch.device("cpu"))
    counts = drv.person_counts(c)
    for b, n in zip(pool, counts):
        assert b["frames"].dtype == torch.uint8 and b["frames"].shape == (2, 2, 112, 112, 3)
        assert b["persons"].count == sum(n) and b["persons"].slots == max(n)
        assert torch.equal(b["persons"].patch, b["patch"])
        assert torch.equal(b["persons"].image, b["image"])


# ---- the cell ---------------------------------------------------------------------------

def test_multihmr_agrees_with_the_reference(ctx):
    r = _run(ctx())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault,caught_by", [
    ("skip_block", "tokens_cos_gap"), ("gamma_one", "tokens_cos_gap"),
    ("swap_images", "tokens_cos_gap"), ("move_centre", "tail_vertices_rel"),
    ("unmask_padding", "tail_vertices_rel"), ("mean_hands", "tail_vertices_rel")])
def test_multihmr_planted_faults(ctx, fault, caught_by):
    r = _run(ctx(fault=fault))
    assert not r["correct"]
    assert r["checks"][caught_by]["value"] > r["checks"][caught_by]["limit"]


def test_multihmr_int8_control(ctx):
    """The reference's int8 backbone and bf16 tail in the program's place."""
    r = _run(ctx(control="int8"))
    assert not r["correct"]


def test_multihmr_lost_person(monkeypatch, ctx):
    """The call's last person dropped where the persons are returned."""
    import airpose_tpu_torch.perception as P

    real = P.perceive_multihmr

    def lost(*a, **k):
        out = real(*a, **k)
        return out._replace(index=out.index[:-1])

    monkeypatch.setattr(P, "perceive_multihmr", lost)
    r = _run(ctx())
    assert not r["correct"] and r["checks"]["persons_index_mismatch"]["value"] >= 1


def test_multihmr_traced_readers(ctx):
    """The traced run's readers: the ``vit``, ``attention`` and ``hph``
    spans' device time is the card's and reads nothing here; the mfu reads
    the measured window."""
    r = _run(ctx(), trace=True)
    m = r["metrics"]
    assert "multihmr_mfu" in m and m["multihmr_mfu"]["value"] > 0
    for name in ("hph_ms.perceive", "vit_attention_roofline.perceive", "vit_ms.perceive",
                 "vit_roofline.perceive"):
        assert name not in m
