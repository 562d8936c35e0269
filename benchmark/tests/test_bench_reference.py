"""The plain reference against the port's plain path at a small size on the
CPU, where both run the same mathematics without kernels."""

import pytest
import torch

from benchmark import harness
from benchmark.drivers import program_body
from benchmark.reference import smplx as ref_smplx
from benchmark.reference.int8 import Int8Trunk
from benchmark.reference.weights import make_smplx, make_state


def test_smplx_matches_the_port():
    from airpose_tpu_torch.bodymodel.smplx import smplx_forward

    body = make_smplx(5, 300, "cpu")
    g = torch.Generator().manual_seed(0)
    betas = torch.randn(4, 10, generator=g)
    pose = ref_smplx.batch_rodrigues(0.3 * torch.randn(4, 21, 3, generator=g))
    orient = ref_smplx.batch_rodrigues(0.3 * torch.randn(4, 1, 3, generator=g))
    v, j = ref_smplx.forward(body, betas, pose, orient)
    out = smplx_forward(program_body(body), betas, body_pose=pose, global_orient=orient,
                        use_kernels=False)
    assert v.shape == (4, 300, 3) and j.shape == (4, 127, 3)
    torch.testing.assert_close(v, out.vertices, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(j, out.joints, rtol=1e-5, atol=1e-6)


def test_int8_trunk_matches_the_port():
    """The quantized weights, the calibrated scales and the features of the
    port's int8 trunk (its plain path) are the reference's, bit for bit."""
    from airpose_tpu_torch.ops.int8_trunk import (calibrate_act_scales, quantize_trunk_params,
                                                  resnet50_int8_infer)

    cfg = harness.load_json(harness.ROOT / "configs" / "airpose_twoview.json")
    sd = make_state(cfg, 3, "cpu")
    trunk_sd = {k[len("trunk."):]: v for k, v in sd.items() if k.startswith("trunk.")}
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    qp = quantize_trunk_params(trunk_sd)
    scales = calibrate_act_scales(qp, x[:2])
    ref = Int8Trunk(sd, cfg["trunk"], 127)
    ref_scales = ref.calibrate(x[:2])
    assert set(scales) == set(ref_scales)
    assert all(scales[k] == float(ref_scales[k]) for k in scales)
    torch.testing.assert_close(resnet50_int8_infer(qp, x, scales), ref(x, ref_scales),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["perceive_int8_b64", "train_hmr_b30", "train_twoview_b30"])
def test_a_run_agrees_with_the_reference(small_ctx, name):
    """A whole run at a small size: the program's plain path and the
    reference agree to rounding, and the run is correct."""
    r = harness.run(small_ctx(name), 0.3, False, 0.0)
    values = {k: v["value"] for k, v in r["checks"].items()}
    assert all(v < 1e-3 for v in values.values()), values
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in harness.cell(name).end_to_end}
