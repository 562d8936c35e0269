"""The work counts behind the roofline and mfu metrics, against hand counts."""

import pytest

from benchmark import harness
from benchmark.roofline import peaks, resnet, step

CFG = harness.load_json(harness.ROOT / "configs" / "airpose_twoview.json")
HMR = harness.load_json(harness.ROOT / "configs" / "hmr_singleview.json")
TRUNK = CFG["trunk"]


def test_resnet50_at_224_is_4_1_gmac_a_crop():
    stem, layers = resnet.trunk_macs(TRUNK, 224)
    assert stem == 112 * 112 * 64 * 3 * 7 * 7
    assert len(resnet.convs(TRUNK, 224)) == 52
    # torchvision's ResNet-50 is 4.09 GMAC at 224², 2.05 M of it the classifier
    assert stem + layers == pytest.approx(4.089e9 - 2.05e6, rel=2e-3)


def test_first_block_by_hand():
    c = {x["name"]: x for x in resnet.convs(TRUNK, 224)}
    assert resnet.conv_macs(c["layer1_0/conv2"]) == 56 * 56 * 9 * 64 * 64
    assert resnet.conv_macs(c["layer2_0/conv2"]) == 28 * 28 * 9 * 128 * 128
    assert resnet.conv_macs(c["layer4_0/proj"]) == 7 * 7 * 1024 * 2048


def test_int8_layers_bytes_by_hand_at_one_crop():
    """Stage by stage: (output side, planes, blocks, first block's input
    channels and side); a block's convs move their int8 inputs, weights,
    multiplier and bias, the projection's bf16 output, conv1/conv2's int8
    outputs, conv3's bf16 shortcut and bf16 + int8 outputs."""
    stages = [(56, 64, 3, 64, 56), (28, 128, 4, 256, 56), (14, 256, 6, 512, 28),
              (7, 512, 3, 1024, 14)]
    total = 56 * 56 * 64 * 3                       # quantize the stem's bf16 map
    couts = 0
    for i, (S, P, n, cin0, sin) in enumerate(stages):
        W = 4 * P
        for b in range(n):
            cin, side = (cin0, sin) if b == 0 else (W, S)
            if b == 0:
                total += sin * sin * cin0 + W * cin0 + 8 * W + S * S * W * 2
                couts += W
            total += side * side * cin + P * cin + 8 * P + side * side * P       # conv1
            total += side * side * P + 9 * P * P + 8 * P + S * S * P             # conv2
            last = i == 3 and b == n - 1
            total += S * S * P + W * P + 8 * W + S * S * W * 2 + S * S * W * (2 if last else 3)
            couts += 2 * P + W
    total += 8 * couts + 7 * 7 * 2048 * 2 + 2048 * 4  # multipliers, the pool
    ops, n_bytes = resnet.int8_layers(TRUNK, 224, 1)
    assert n_bytes == total
    assert ops == 2 * resnet.trunk_macs(TRUNK, 224)[1]


def test_int8_layers_byte_bound_at_128_crops():
    ops, n_bytes = resnet.int8_layers(TRUNK, 224, 128)
    t = peaks.least_seconds({"int8": ops}, n_bytes)
    assert t == pytest.approx(n_bytes / peaks.HBM_BYTES)   # bound by bytes
    assert 1.6e-3 < t < 1.9e-3                               # chip_smoke's 52 convs: 1.6999 ms


def test_stem_cost():
    ops, n_bytes = resnet.stem(TRUNK, 224, 128)
    assert ops == 2 * 128 * 112 * 112 * 64 * 147
    assert n_bytes == 128 * 224 * 224 * 3 * 4 + 64 * 147 * 2 + 64 * 4 + 128 * 56 * 56 * 64 * 2


def test_step_counts():
    p = step.perceive_ops(CFG, 64, "int8")
    assert p["int8"] == pytest.approx(2 * 128 * resnet.trunk_macs(TRUNK, 224)[1])
    assert p["bf16"] == pytest.approx(2 * 128 * resnet.trunk_macs(TRUNK, 224)[0])
    # SMPL-X: shape blend, joint regressor, pose blend (486 × 31,425), skinning's transforms
    # (10,475 · 55 · 12) and their application (10,475 · 9)
    assert step.smplx_macs(CFG["smplx"]) == (10475 * 3 * 10 + 55 * 10475 * 3 + 486 * 31425
                                             + 10475 * 55 * 12 + 10475 * 9)
    assert step.regressor_macs(CFG) == 2332 * 1024 + 1024 * 1024 + 1024 * 145
    t = step.train_ops(CFG, 30)
    h = step.train_ops(HMR, 30)
    assert t["bf16"] == pytest.approx(2 * h["bf16"])      # two views, one trunk
    assert t["bf16"] == pytest.approx(1.47e12, rel=0.02)  # ~1.48 TFLOP a two-view step
    assert peaks.least_seconds(t) == pytest.approx(t["bf16"] / 989e12 + t["fp32"] / 67e12)
