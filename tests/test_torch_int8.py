"""Port parity of the int8 PTQ serving trunk: quantization, calibration, the
per-conv int8 trunk (ops/int8_trunk.py), the int8 bottleneck blocks
(ops/int8_bottleneck.py) and the int8 perception chain, against the JAX
package on the same numpy inputs and weights, on the CPU (the conv kernel's
plain version; the JAX Pallas blocks in interpret mode).

The carried tables (``int8_operands_from_jax``) give both packages
identical int8 weights and activation scales; the port's own quantization
and calibration are held to the JAX ones separately."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu import constants as JC
from airpose_tpu.bodymodel import smplx_forward as jsmplx_forward
from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic
from airpose_tpu.geometry.rotations import rot6d_to_rotmat as jrot6d
from airpose_tpu.models import AirPoseTwoView as JAirPoseTwoView
from airpose_tpu.models.resnet import ResNet50 as JResNet50
from airpose_tpu.ops import int8_bottleneck as jb
from airpose_tpu.ops import int8_trunk as jq
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu.train.losses import cam_frame_and_project as jproject
from airpose_tpu_torch.bodymodel import synthetic_smplx_params
from airpose_tpu_torch.models import AirPoseTwoView
from airpose_tpu_torch.ops import int8_bottleneck as tb
from airpose_tpu_torch.ops import int8_trunk as tq
from airpose_tpu_torch.perception import chain_ops, perceive
from airpose_tpu_torch.train.checkpoint import (int8_operands_from_jax,
                                                load_reference_state_dict,
                                                state_dict_from_flax)

B, IMG, V = 2, 64, 512


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """A seeded port AirPoseTwoView with BN statistics moved off (0, 1), the
    same weights as flax variables, the chain's inputs (B = 2 frames of
    64² crops), and the JAX int8 operands calibrated on the first frame's
    two crops (bench.py:98-102), carried into the port."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in AirPoseTwoView(seed=0).state_dict().items():
        if k.endswith("running_mean"):
            v = v + torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = v * torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
        sd["model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k)] = v
    variables = convert_reference_checkpoint(sd)
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=1)
    load_reference_state_dict(model, state_dict_from_flax(variables))

    images = rng.normal(size=(B, 2, IMG, IMG, 3)).astype(np.float32)
    bb = rng.normal(size=(B, 2, 3)).astype(np.float32) * 0.1
    pos = np.full((B, 2, 3), 10.0 * JC.TRANS_SCALE, np.float32)
    fx, fy = JC.FOCAL_LENGTH
    intr = np.broadcast_to(np.asarray([[fx, 0, JC.CX], [0, fy, JC.CY], [0, 0, 1.0]],
                                      np.float32), (B, 2, 3, 3)).copy()
    calib = images[0]  # the first frame's two crops

    qp = jq.quantize_trunk_params(variables)
    scales = jq.calibrate_act_scales(qp, jnp.asarray(calib))
    pblocks = jb.quantize_trunk_pallas(variables, scales)
    carried = int8_operands_from_jax(_np_tree(qp), scales, _np_tree(pblocks))
    return dict(variables=variables, model=model, inputs=(images, bb, pos, intr),
                calib=calib, qp=qp, scales=scales, pblocks=pblocks, carried=carried)


def test_quantize_weight_matches_jax(rng):
    k = rng.normal(size=(3, 3, 32, 16)).astype(np.float32) * 0.3
    k[..., 3] = 0.0  # an all-zero channel takes the 1e-12 scale floor
    wq, ws = jq.quantize_weight(k)
    got_q, got_s = tq.quantize_weight(torch.from_numpy(k.transpose(3, 0, 1, 2).reshape(16, -1)))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(),
                                  np.asarray(wq).transpose(3, 0, 1, 2).reshape(16, -1))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ws), rtol=1e-6, atol=0)


def test_quantize_trunk_params_matches_jax(setup):
    """Folding BN in torch and in numpy may round one f32 ulp apart (measured:
    scales within 2.4e-7 relative, no int8 weight differing); the bound
    allows the int8 step that ulp can flip on < 1e-4 of the entries."""
    got = tq.quantize_trunk_params(setup["model"].trunk.state_dict())
    want = setup["carried"][0]
    n_diff = n = 0
    for name, blk in want.items():
        if name == "stem":
            np.testing.assert_allclose(got[name]["b"].numpy(), blk["b"].numpy(),
                                       rtol=1e-5, atol=1e-6)
            continue
        for conv, q in blk.items():
            d = (got[name][conv]["wq"].int() - q["wq"].int()).abs()
            assert int(d.max()) <= 1, f"{name}/{conv}"
            n_diff, n = n_diff + int((d > 0).sum()), n + d.numel()
            np.testing.assert_allclose(got[name][conv]["ws"].numpy(), q["ws"].numpy(),
                                       rtol=1e-6, atol=0, err_msg=f"{name}/{conv}")
            np.testing.assert_allclose(got[name][conv]["b"].numpy(), q["b"].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name}/{conv}")
    assert n_diff < 1e-4 * n, (n_diff, n)


@pytest.mark.parametrize("ksize,stride,act,fused", [
    (1, 1, "static", False),
    (1, 2, "static", False),
    (3, 1, "dynamic", True),     # relu(y + res) fused into the epilogue
    (3, 2, "static", False),
])
def test_qconv_exact(rng, ksize, stride, act, fused):
    """On identical int8 weights and scales the port's _qconv equals JAX's
    bit for bit: the same round-half-even quantization, an exact integer
    accumulation and the same f32 epilogue operations."""
    cin, cout, N, H, W = 64, 96, 2, 9, 13
    x = jnp.asarray(rng.normal(size=(N, H, W, cin)).astype(np.float32) * 2.0, jnp.bfloat16)
    wq = rng.integers(-127, 128, size=(ksize, ksize, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.5, 1.5, cout).astype(np.float32) * 1e-3
    b = rng.normal(size=cout).astype(np.float32) * 0.1
    s = None if act == "dynamic" else float(np.abs(np.asarray(x, np.float32)).max() / 100.0)
    want = jq._qconv(x, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b), stride=stride,
                     act_scale=None if s is None else jnp.float32(s))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    conv = {"wq": torch.from_numpy(wq.transpose(3, 0, 1, 2).reshape(cout, -1).copy()),
            "ws": torch.from_numpy(ws), "b": torch.from_numpy(b)}
    res = None
    if fused:
        res_np = rng.normal(size=want.shape).astype(np.float32)
        want = jax.nn.relu(want + jnp.asarray(res_np, jnp.bfloat16))
        res = torch.from_numpy(res_np).to(torch.bfloat16)
    got = tq._qconv(xt, conv, ksize, stride, act_scale=s, relu=fused, res=res)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_calibrate_act_scales_matches_jax(setup):
    """The port's own quantization and calibration against JAX's: 52
    per-tensor scales. The stem and the int8 convs agree bit for bit on
    identical operands (test_resnet50_int8_infer_matches_jax), but a scale
    one ulp apart after BN folding can flip a bf16 rounding that moves a
    later maximum. Measured: every scale equal on this trunk; on another
    seed (a bare trunk, 0.3-scaled inputs) median 0 and maximum 2.2e-2.
    Bound 0.05 per entry."""
    model = setup["model"]
    got = tq.calibrate_act_scales(tq.quantize_trunk_params(model.trunk.state_dict()),
                                  torch.from_numpy(setup["calib"]))
    want = setup["scales"]
    assert sorted(got) == sorted(want) and len(got) == 52
    rel = np.array([abs(got[k] / float(want[k]) - 1.0) for k in want])
    assert rel.max() < 0.05, rel.max()
    assert np.median(rel) < 1e-6, np.median(rel)


@pytest.mark.parametrize("stages,bound", [
    ((1, 2, 3, 4), 0.0),   # measured 0: bit for bit
    ((), 0.02),            # folded bf16 convs only: measured 4.8e-3
    ((3, 4), 0.1),         # measured 4.6e-2
])
def test_resnet50_int8_infer_matches_jax(setup, stages, bound):
    """The int8 trunk on the carried tables: the all-int8 trunk equals JAX's
    exactly; stages kept as bf16 convs differ by the rounding points of
    oneDNN vs XLA bf16 convolutions, which later int8 stages amplify."""
    qp, scales, _ = setup["carried"]
    x = setup["inputs"][0].reshape(B * 2, IMG, IMG, 3) * 0.3
    want = np.asarray(jq.resnet50_int8_infer(setup["qp"], jnp.asarray(x),
                                             act_scales=setup["scales"], int8_stages=stages))
    got = tq.resnet50_int8_infer(qp, torch.from_numpy(x), scales, int8_stages=stages).numpy()
    assert got.shape == (B * 2, 2048) and got.dtype == np.float32
    assert _rel(got, want) <= bound, _rel(got, want)


def _lax_block(x, blk):
    """tests/test_int8_bottleneck.py's lax transcription of the block's math:
    int8 convs with int32 accumulation and the static-scale epilogues."""
    stride = 2 if "wp" in blk else 1
    cmid = blk["w1"].shape[1]

    def conv(x, w, s=1):
        return jax.lax.conv_general_dilated(
            x, w, (s, s), ((1, 1), (1, 1)) if w.shape[0] == 3 else "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)

    def requant(acc, m, b):
        y = jax.nn.relu(acc.astype(jnp.float32) * m + b)
        return jnp.clip(jnp.round(y), 0.0, 127.0).astype(jnp.int8)

    cin = x.shape[-1]
    y1 = requant(conv(x, blk["w1"].reshape(1, 1, cin, cmid)), blk["m1"], blk["b1"])
    y2 = requant(conv(y1, blk["w2"].reshape(3, 3, cmid, cmid), s=stride), blk["m2"], blk["b2"])
    y3 = conv(y2, blk["w3"].reshape(1, 1, cmid, -1)).astype(jnp.float32) * blk["m3"] + blk["b3"]
    if "wp" in blk:
        accp = conv(x[:, ::stride, ::stride, :], blk["wp"].reshape(1, 1, cin, -1))
        res = accp.astype(jnp.float32) * blk["mp"] + blk["bp"]
    else:
        res = x.astype(jnp.float32) * blk["r"]
    out = jax.nn.relu(y3 + res)
    if blk["meta"].out_int8:
        return jnp.clip(jnp.round(out), 0.0, 127.0).astype(jnp.int8)
    return out.astype(jnp.bfloat16)


@pytest.mark.parametrize("idx,hw", [(0, 8), (1, 4), (12, 2)],
                         ids=["projection", "identity", "bf16_final"])
def test_int8_block_reference_matches_lax(setup, rng, idx, hw):
    """One projection (layer2_0, stride 2), one identity (layer2_1) and the
    bf16-final block (layer4_2) at full channel widths: ≤ 1 int8 step on
    < 0.5% of elements, the JAX package's bound for its Pallas block
    (measured: exact)."""
    jblk = setup["pblocks"]["blocks"][idx]
    blk = setup["carried"][2]["blocks"][idx]
    cin = blk["w1"].shape[1]
    x = rng.integers(0, 127, size=(2, hw, hw, cin)).astype(np.int8)
    want = np.asarray(jax.jit(_lax_block)(jnp.asarray(x), jblk), np.float32)
    got = tb.int8_block(torch.from_numpy(x), blk)
    assert got.dtype == (torch.int8 if blk["out_int8"] else torch.bfloat16)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0).mean() < 5e-3, (diff > 0).mean()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_block_rejects_odd_sizes_at_stride_2(setup):
    blk = setup["carried"][2]["blocks"][0]
    with pytest.raises(ValueError, match="even"):
        tb.int8_block(torch.zeros(1, 5, 4, 256, dtype=torch.int8), blk)


def test_resnet50_int8_block_infer_matches_pallas(setup):
    """The int8-block trunk vs the JAX Pallas trunk in interpret mode on the
    carried tables, and both vs the bf16 trunk at the JAX package's PTQ
    bounds (corr > 0.9, rel < 0.35). The port-vs-JAX difference comes from
    the bf16 front (oneDNN vs XLA rounding points, then int8 rounding
    flips): measured rel-L2 4.4e-2 at 64² (1.6e-2 on another seed);
    bound 0.1, the JAX package's bound for its bf16 fused trunk."""
    model = setup["model"]
    x = setup["inputs"][0].reshape(B * 2, IMG, IMG, 3) * 0.3
    jtrunk = JResNet50(dtype=jnp.bfloat16)
    want = np.asarray(jb.resnet50_int8_pallas_infer(jtrunk, setup["variables"],
                                                    setup["pblocks"], jnp.asarray(x),
                                                    interpret=True))
    with torch.no_grad():
        got = tb.resnet50_int8_block_infer(model.trunk, setup["carried"][2],
                                           torch.from_numpy(x)).numpy()
        bf16 = model.trunk(torch.from_numpy(x)).numpy()
    assert got.shape == (B * 2, 2048)
    assert np.corrcoef(got.ravel(), bf16.ravel())[0, 1] > 0.9
    assert _rel(got, bf16) < 0.35
    assert _rel(got, want) < 0.1, _rel(got, want)


def _jax_int8_perceive(s, smplx_params):
    """bench.py:104-125's int8 perceive, composed of JAX functions."""
    model = JAirPoseTwoView(dtype=jnp.bfloat16)
    images, bb, pos, intr = (jnp.asarray(t) for t in s["inputs"])
    out = jq.twoview_int8_forward(model, s["variables"], s["qp"], s["scales"], images, bb, pos)
    trans = out.pose[..., :3] / JC.TRANS_SCALE
    rotmat = jrot6d(out.pose[..., 3:].reshape(B, 2, 22, 6))
    body = jsmplx_forward(
        smplx_params, out.betas.reshape(B * 2, 10),
        body_pose=rotmat[:, :, 1:].reshape(B * 2, 21, 3, 3),
        global_orient=jnp.broadcast_to(jnp.eye(3), (B * 2, 1, 3, 3)))
    _, j2d = jproject(rotmat[:, :, 0], trans, body.joints.reshape(B, 2, -1, 3),
                      intr, JC.FOCAL_LENGTH)
    return out.pose, body.vertices.reshape(B, 2, -1, 3), j2d


def test_int8_chain_matches_jax(setup):
    """perceive through the int8 trunk (carried tables) vs bench.py's int8
    chain in JAX: pose MAD < 0.15·RMS (tests/test_int8_trunk.py's bound)
    and rel-L2 of j2d and verts < 0.02 (measured: pose MAD 4.3e-7·RMS, j2d
    3.1e-7, verts 1.8e-6; the trunks agree bit for bit, so only the f32 IEF
    and SMPL-X summation orders differ)."""
    model = setup["model"]
    qp, scales, _ = setup["carried"]
    images, bb, pos, intr = (torch.from_numpy(t) for t in setup["inputs"])
    verts, j2d = perceive(model, synthetic_smplx_params(num_vertices=V), images, bb, pos,
                          intr, partial(tq.resnet50_int8_infer, qp, act_scales=scales))
    assert verts.shape == (B, 2, V, 3) and j2d.shape == (B, 2, 127, 2)
    with torch.no_grad():
        pose = tq.twoview_int8_forward(model, qp, scales, images, bb, pos).pose.numpy()
    pose_j, verts_j, j2d_j = _jax_int8_perceive(setup, jsynthetic(num_vertices=V))
    dpose = np.abs(pose - np.asarray(pose_j))
    assert dpose.mean() < 0.15 * np.asarray(pose_j).std(), dpose.mean()
    assert _rel(j2d.numpy(), j2d_j) < 0.02, _rel(j2d.numpy(), j2d_j)
    assert _rel(verts.numpy(), verts_j) < 0.02, _rel(verts.numpy(), verts_j)


def test_int8_inference_view_folded(setup):
    """The port's Int8Inference (its own quantization and calibration) on
    view-folded input: equal to twoview_int8_forward on its tables, its
    single-view features are the folded ones, and it tracks JAX's shim
    within the PTQ pose bound (measured MAD 4.3e-7·RMS)."""
    model = setup["model"]
    images, bb, pos, _ = (torch.from_numpy(t) for t in setup["inputs"])
    shim = tq.Int8Inference(model, torch.from_numpy(setup["calib"]))
    got = shim.apply(images, bb, pos)
    with torch.no_grad():
        want = tq.twoview_int8_forward(model, shim.qparams[0], shim.act_scales[0], images, bb,
                                       pos)
    torch.testing.assert_close(got.pose, want.pose, rtol=0, atol=0)
    torch.testing.assert_close(shim._features(images[:, 1]),
                               shim._features(images)[:, 1], rtol=0, atol=0)
    rates = shim.clip_report(images)
    assert len(rates) == 52 and all(0.0 <= r <= 1.0 for r in rates.values())
    with pytest.raises(ValueError, match="inference-only"):
        shim.apply(images, bb, pos, train=True)

    jmodel = JAirPoseTwoView(dtype=jnp.bfloat16)
    jshim = jq.Int8Inference(jmodel, setup["variables"], jnp.asarray(setup["calib"]))
    pose_j = np.asarray(jshim.apply(setup["variables"], *(jnp.asarray(t) for t in
                                                          setup["inputs"][:3])).pose)
    dpose = np.abs(got.pose.numpy() - pose_j)
    assert dpose.mean() < 0.15 * pose_j.std(), dpose.mean()


def test_chain_ops_prepares_each_trunk(setup):
    """chain_ops quantizes and calibrates for both int8 trunks once, the
    int8-block operands are quantize_trunk_blocks of the same tables, and
    each returned features function runs its trunk on crops."""
    model = setup["model"]
    calib = torch.from_numpy(setup["calib"])
    int8 = chain_ops(model, "int8", calib)
    block = chain_ops(model, "int8_block", calib)
    qparams, scales = int8.args[0], int8.keywords["act_scales"]
    assert len(scales) == 52
    want = tb.quantize_trunk_blocks(qparams, scales)
    blocks = block.args[1]
    assert blocks["s_in"] == want["s_in"] and len(blocks["blocks"]) == 13
    for got_b, want_b in zip(blocks["blocks"], want["blocks"]):
        assert got_b.keys() == want_b.keys()
        for k, v in want_b.items():
            assert torch.equal(got_b[k], v) if torch.is_tensor(v) else got_b[k] == v
    with torch.no_grad():
        torch.testing.assert_close(int8(calib), tq.resnet50_int8_infer(qparams, calib, scales),
                                   rtol=0, atol=0)
        torch.testing.assert_close(block(calib, use_kernels=False),
                                   tb.resnet50_int8_block_infer(model.trunk, blocks, calib),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown trunk"):
        chain_ops(model, "fp8", calib)


def test_quantize_trunk_blocks_matches_jax(setup):
    """quantize_trunk_blocks on the carried qparams and scales equals JAX's
    quantize_trunk_pallas operands (m and b formed in f32 in its order)."""
    qp, scales, want = setup["carried"]
    got = tb.quantize_trunk_blocks(qp, scales)
    assert got["s_in"] == want["s_in"]
    for g, w in zip(got["blocks"], want["blocks"]):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if torch.is_tensor(v):
                assert torch.equal(g[k].reshape(v.shape), v), k
            else:
                assert g[k] == v, k


def test_int8_trunk_is_batch_invariant(setup):
    """One crop's int8 features alone (B = 1) and as the first of 60 crops
    (the folded two-view batch of compile_results --int8 at B = 30): JAX's
    op-by-op int8 trunk and the port's on the CPU, each on the carried
    tables. Measured equal bit for bit in both packages; the card's cuDNN
    stem is checked the same way in chip_smoke.py phase 14."""
    qp, scales, _ = setup["carried"]
    crops = np.random.default_rng(3).normal(size=(60, IMG, IMG, 3)).astype(np.float32) * 0.3
    feats = {}
    for n in (1, 60):
        x = crops[:n]
        feats["jax", n] = np.asarray(jq.resnet50_int8_infer(
            setup["qp"], jnp.asarray(x), act_scales=setup["scales"]))[0]
        feats["port", n] = tq.resnet50_int8_infer(qp, torch.from_numpy(x), scales).numpy()[0]
    np.testing.assert_array_equal(feats["jax", 60], feats["jax", 1])
    np.testing.assert_array_equal(feats["port", 60], feats["port", 1])
    np.testing.assert_array_equal(feats["port", 1], feats["jax", 1])


def _within_one_bf16_step(a, b):
    """|a − b| ≤ one bf16 step of the larger value, + 1e-6 (sums that cancel)."""
    return bool((np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7 + 1e-6).all())


@pytest.mark.parametrize("n", [1, 5])
def test_int8_stem_map_matches_jax(setup, n):
    """The stem's bf16 convolution map (before bias and pool) and the whole
    stem (conv, pool, bias, relu) on the carried weights at B = 1 and B = 5.
    XLA's and torch's CPU convolutions sum the 147 products in other orders,
    so the two maps lie one bf16 step apart on a few elements (measured
    3.7e-5 to 7.0e-5 of them at 64² and 224², N(0, 1) and N(0, 0.09)
    crops): bound one step of the larger of the two values, plus 1e-6 for
    the few sums that cancel to below 1e-4 (f32 rounding of 147 products of
    size ~0.1 is ~1e-7 there), on at most 2e-4 of the map. Crop 0's map is
    the same bits at both batch sizes."""
    from airpose_tpu_torch.ops import int8_stem

    qp, _, _ = setup["carried"]
    crops = np.random.default_rng(4).normal(size=(5, IMG, IMG, 3)).astype(np.float32)[:n]
    w_hwio = setup["qp"]["stem"]["w"]
    jmap = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(crops).astype(jnp.bfloat16), w_hwio, (2, 2), ((3, 3), (3, 3)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")).astype(jnp.float32))
    tmap = int8_stem.stem_conv(torch.from_numpy(crops), qp["stem"]["w"]).float().numpy()
    assert tmap.shape == (n, IMG // 2, IMG // 2, 64)
    assert _within_one_bf16_step(tmap, jmap)
    assert (tmap != jmap).mean() <= 2e-4
    # the kernel's fixed-order arithmetic in torch ops, within one bf16 step
    # of the plain convolution (another order of summation)
    ordered = int8_stem.stem_conv_ordered(torch.from_numpy(crops), qp["stem"]["w"]).float()
    assert _within_one_bf16_step(ordered.numpy(), tmap)
    one = int8_stem.stem_conv(torch.from_numpy(crops[:1]), qp["stem"]["w"]).float().numpy()
    np.testing.assert_array_equal(one[0], tmap[0])
    tstem = tq.int8_stem(qp["stem"], torch.from_numpy(crops)).float().numpy()
    h = jnp.asarray(jmap).astype(jnp.bfloat16)
    h = jax.nn.relu((h.astype(jnp.float32) + setup["qp"]["stem"]["b"]).astype(jnp.bfloat16))
    h = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                              ((0, 0), (1, 1), (1, 1), (0, 0)))
    jstem = np.asarray(h.astype(jnp.float32))
    # after the bias (which can cancel the map) a flipped map value moves
    # the output by one step of the map, not of the output
    assert np.abs(tstem - jstem).max() <= np.abs(jmap).max() * 2.0 ** -7
    assert (tstem != jstem).mean() <= 2e-4
