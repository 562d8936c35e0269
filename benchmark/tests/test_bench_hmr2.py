"""The two perception cells this file's drivers run, at a small size on the
CPU: HMR 2.0 (``perceive_hmr2_vith_b64``, the configuration shrunk to width
64, 2 blocks and a 2-layer decoder) and the bf16 trunk
(``perceive_bf16_b64``). Each agrees with the reference, and ``correct``
comes out false with a planted fault or with the control (the next lower
precision) in the program's place. Also HMR 2.0's work counts
(``roofline/vit.py``), by hand at the published sizes and against the
reference's own products at the small size."""

import copy
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.reference import hmr2 as ref
from benchmark.roofline import peaks, step, vit

HMR2_CELL, BF16_CELL = "perceive_hmr2_vith_b64", "perceive_bf16_b64"
HMR2_CFG = harness.load_json(harness.ROOT / "configs" / "hmr2_vith.json")


def small_hmr2_config():
    cfg = copy.deepcopy(HMR2_CFG)
    cfg["backbone"].update(img_size=[64, 48], width=64, depth=2, heads=4, tokens=12)
    cfg["head"].update(dim=32, depth=2, heads=2, dim_head=8, mlp_dim=48, context_dim=64)
    return cfg


@pytest.fixture
def hmr2_ctx(small_ctx, monkeypatch):
    """A CPU context of the HMR 2.0 cell at the tests' small sizes and the
    small configuration. The published draw (std 0.02 whatever the width)
    makes a block of width 64 add about a twentieth of what it adds at
    1,280: the blocks' linears are scaled by √(1280 / 64), so that a block
    weighs in the small backbone as much as in the published one."""
    real = ref.make_state

    def make_state(cfg, seed, device):
        sd = real(cfg, seed, device)
        for k, v in sd.items():
            if k.startswith("backbone.blocks.") and v.ndim == 2:
                v.mul_((HMR2_CFG["backbone"]["width"] / cfg["backbone"]["width"]) ** 0.5)
        return sd
    monkeypatch.setattr(ref, "make_state", make_state)

    def make(**kw):
        ctx = small_ctx(HMR2_CELL, **kw)
        ctx.cell = dataclasses.replace(ctx.cell, config=small_hmr2_config())
        return ctx
    return make


def _run(ctx):
    return harness.run(ctx, 0.3, False, 0.0)


# ---- the counts --------------------------------------------------------------------

def test_vit_h_counts_by_hand():
    vb = HMR2_CFG["backbone"]
    T, C = 192, 1280
    assert vit.patch_macs(vb) == T * 768 * C
    assert vit.block_macs(vb) == T * (3 * C * C + C * C + 2 * 4 * C * C) + 2 * 16 * T * T * 80
    assert vit.block_macs(vb) / T == pytest.approx(20.2e6, rel=3e-3)
    # ViT-H/16 is 630-632 M parameters with its 192 + 1 position embeddings
    assert 630e6 < vit.backbone_params(vb) < 633e6
    assert vit.head_macs(HMR2_CFG) == pytest.approx(1.5e9, rel=0.03)
    ops, n_bytes = vit.vit(HMR2_CFG, 128)
    assert ops / 128 == pytest.approx(248e9, rel=0.01)
    assert peaks.least_seconds({"bf16": ops}, n_bytes) == pytest.approx(ops / 989e12)
    assert step.smplx_macs(HMR2_CFG["smplx"]) == (6890 * 30 + 24 * 6890 * 3 + 207 * 6890 * 3
                                                  + 6890 * 24 * 12 + 6890 * 9)


@pytest.mark.parametrize("part", ["backbone", "head"])
def test_vit_counts_match_the_references_products(part):
    """The multiply-adds of ``roofline/vit.py`` are exactly the products the
    plain reference runs (its linears, convolution and attention matmuls),
    counted by PyTorch's flop counter."""
    cfg = small_hmr2_config()
    sd = ref.make_state(cfg, 0, "cpu")
    n = 3
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if part == "backbone":
            ref.backbone(sd, cfg, torch.zeros(n, 64, 64, 3))
            want = vit.vit(cfg, n)[0]
        else:
            ref.head(sd, cfg, torch.zeros(n, 12, 64))
            want = 2.0 * n * vit.head_macs(cfg)
    assert fc.get_total_flops() == want
    params = sum(v.numel() for k, v in sd.items() if k.startswith("backbone."))
    assert vit.backbone_params(cfg["backbone"]) == params


# ---- HMR 2.0 --------------------------------------------------------------------------

def test_hmr2_agrees_with_the_reference(hmr2_ctx):
    r = _run(hmr2_ctx())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] % 2 == 0


@pytest.mark.parametrize("fault,caught_by", [("skip_block", "tokens_cos_gap"),
                                             ("swap_crops", "tokens_cos_gap"),
                                             ("scale_tokens", "tokens_call_rel")])
def test_hmr2_planted_faults(hmr2_ctx, fault, caught_by):
    r = _run(hmr2_ctx(fault=fault))
    assert not r["correct"]
    assert r["checks"][caught_by]["value"] > r["checks"][caught_by]["limit"]


def test_hmr2_int8_control(hmr2_ctx):
    """The reference's int8 backbone and bf16 tail in the program's place:
    further from the float32 reference than the program's bf16 backbone."""
    ok = _run(hmr2_ctx())["checks"]
    r = _run(hmr2_ctx(control="int8"))
    assert not r["correct"]
    assert r["checks"]["tokens_cos_gap"]["value"] > 5 * ok["tokens_cos_gap"]["value"]


def test_hmr2_altered_answer(monkeypatch, hmr2_ctx):
    """One body's vertices moved by a decimetre where they are produced."""
    import airpose_tpu_torch.perception as P

    real = P.perceive_hmr2

    def altered(*a, **k):
        verts, j2d = real(*a, **k)
        verts = verts.clone()
        verts[0, 1] += 0.1
        return verts, j2d

    monkeypatch.setattr(P, "perceive_hmr2", altered)
    r = _run(hmr2_ctx())
    assert not r["correct"] and r["checks"]["tokens_cos_gap"]["value"] < 1e-2


def test_hmr2_traced_readers(hmr2_ctx):
    """The traced run's readers: the ``vit`` span's device time is the
    card's and reads nothing here; the mfu reads the measured window."""
    r = harness.run(hmr2_ctx(), 0.3, True, 0.0)
    m = r["metrics"]
    assert "perceive_hmr2_mfu" in m and m["perceive_hmr2_mfu"]["value"] > 0
    assert "vit_ms.perceive" not in m and "vit_roofline.perceive" not in m


# ---- the bf16 trunk ---------------------------------------------------------------------

def test_bf16_agrees_with_the_reference(small_ctx):
    r = _run(small_ctx(BF16_CELL))
    assert r["correct"], r["checks"]


def test_bf16_int8_control(small_ctx):
    r = _run(small_ctx(BF16_CELL, control="int8"))
    assert not r["correct"]


def test_bf16_half_the_batch(monkeypatch, small_ctx):
    """The trunk runs the first half of the crops and repeats them."""
    import airpose_tpu_torch.perception as P

    real = P.chain_ops

    def half_chain(*a, **k):
        f = real(*a, **k)

        def features(x, use_kernels=True):
            h = f(x[: x.shape[0] // 2], use_kernels=use_kernels)
            return torch.cat([h, h])
        return features

    monkeypatch.setattr(P, "chain_ops", half_chain)
    assert not _run(small_ctx(BF16_CELL))["correct"]


def test_bf16_altered_answer(monkeypatch, small_ctx):
    import airpose_tpu_torch.perception as P

    real = P.perceive

    def altered(*a, **k):
        verts, j2d = real(*a, **k)
        verts = verts.clone()
        verts[0, 1] += 0.5
        return verts, j2d

    monkeypatch.setattr(P, "perceive", altered)
    assert not _run(small_ctx(BF16_CELL))["correct"]
