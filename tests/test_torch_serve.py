"""Port parity of the serving slice (airpose_tpu_torch.serve vs
airpose_tpu.serve, on the CPU): the wire bytes and their decoders, the
staged step 1/2/3 of StagedRegressor (f32, the per-drone ``_sep`` halves,
and the int8 trunk on int8 operands and scales carried from a JAX regressor
that calibrated), the 3-round protocol against the port's fused forward,
and the lag-one report.

Weights start from a seeded port model (a flax ResNet-50 init would take
~20 s a trunk), with BatchNorm statistics moved off (0, 1), and reach flax
through the reference state dict (convert_reference_checkpoint); the port
models under test load them back through state_dict_from_flax. Crops are
64² uint8 from a numpy seed. Tolerances: the staged steps atol 1e-4
(tests/test_torch_models.py's for the f32 trunk and IEF; tests/test_serve.py
holds JAX's staged path to its fused forward at the same bound), the int8
features bit for bit against JAX's int8 trunk op by op (both compute exact
integer convolutions) and the int8 pose within tests/test_torch_int8.py's
chain bound of JAX's staged steps, the port's own
staged protocol against its fused forward 1e-5, the lag-one report 1e-4
and < 1e-6 on a static scene (tests/test_serve.py's)."""

import asyncio
import struct

import jax
import numpy as np
import pytest
import torch

from airpose_tpu.ops import int8_trunk as jq
from airpose_tpu.serve import protocol as JP
from airpose_tpu.serve.lagone import lag_one_report as jlag_one_report
from airpose_tpu.serve.staged import StagedRegressor as JStagedRegressor
from airpose_tpu.serve.staged import state_to_wire as jstate_to_wire
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu_torch import constants as C
from airpose_tpu_torch.models import MODEL_REGISTRY
from airpose_tpu_torch.serve import protocol as P
from airpose_tpu_torch.serve.lagone import lag_one_report
from airpose_tpu_torch.serve.staged import StagedRegressor, state_to_wire, wire_to_peer
from airpose_tpu_torch.train.checkpoint import (int8_operands_from_jax,
                                                load_reference_state_dict,
                                                state_dict_from_flax)

IMG = 64
SEP = "copenet_twoview_sep"
INIT_TRANS = np.asarray([0.0, 0.0, 10.0], np.float32)
STAGED_CASES = [("copenet_twoview", None), (SEP, 0), (SEP, 1)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_sd(model, family):
    """The port model's state dict under the reference net's keys."""
    out = {}
    for k, v in model.state_dict().items():
        head, rest = k.split(".", 1) if "." in k else (k, k)
        if family == SEP:
            out[f"model.copenet{head[-1]}.{rest}"] = v
        else:
            out["model." + (rest if head in ("trunk", "core") else k)] = v
    return out


@pytest.fixture(scope="module")
def carried():
    """Per family: its weights as flax variables (from a seeded port model,
    BN statistics perturbed) and a port model of another seed that loaded
    them back."""
    rng = np.random.default_rng(0)
    out = {}
    for i, family in enumerate(("copenet_twoview", SEP)):
        model = MODEL_REGISTRY[family](seed=i)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(torch.from_numpy(rng.normal(0, 0.05, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.mul_(torch.from_numpy(rng.uniform(0.8, 1.2, buf.shape).astype(np.float32)))
        variables = convert_reference_checkpoint(reference_sd(model, family), family)
        port = MODEL_REGISTRY[family](seed=100 + i)
        load_reference_state_dict(port, state_dict_from_flax(variables, family), family)
        out[family] = (variables, port)
    return out


def crops(seed, n=2, img=IMG):
    """(n, img, img, 3) uint8 crops and (n, 3) bb from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8),
            (rng.normal(size=(n, 3)) * 0.1).astype(np.float32))


# ---------------------------------------------------------------- the wire

def test_framing_constants_equal_jax():
    for name in ("MAGIC", "MSG_IMAGE", "MSG_STEP1", "MSG_STEP2", "MSG_RESULT", "MSG_HELLO",
                 "MAX_PAYLOAD", "MAX_IMAGE_DIM"):
        assert getattr(P, name) == getattr(JP, name), name
    assert P._HEADER.format == JP._HEADER.format == "<IBI"
    assert C.WIRE_NUM_FLOATS == 145


def test_params_pack_equals_jax(rng):
    betas = rng.normal(size=(10,)).astype(np.float32)
    trans = np.asarray([0.4, -0.2, 9.0], np.float32)
    pose = rng.normal(size=(132,)).astype(np.float32)
    data = P.pack_params(betas, trans, pose)
    assert data.tobytes() == JP.pack_params(betas, trans, pose).tobytes()
    for got, want in zip(P.unpack_params(data), JP.unpack_params(data)):
        np.testing.assert_array_equal(got, want)


def test_image_message_bytes_and_cross_decode(rng):
    img = rng.integers(0, 256, (IMG, 48, 3), dtype=np.uint8)
    bb, init_trans = np.asarray([0.1, 0.2, 1.5]), np.asarray([0.0, 0.3, 10.0])
    raw = P.encode_image(2, 42, bb, init_trans, img)
    assert raw == JP.encode_image(2, 42, bb, init_trans, img)
    for decode in (P.decode_image, JP.decode_image):
        robot, fid, bb2, trans2, img2 = decode(raw[9:])
        assert (robot, fid) == (2, 42)
        np.testing.assert_array_equal(bb2, bb.astype(np.float32))
        np.testing.assert_array_equal(trans2, init_trans.astype(np.float32))
        np.testing.assert_array_equal(img2, img)


@pytest.mark.parametrize("msg_type", [P.MSG_STEP1, P.MSG_STEP2, P.MSG_RESULT])
def test_step_message_bytes_and_cross_decode(rng, msg_type):
    data = rng.normal(size=(145,)).astype(np.float32)
    raw = P.encode_step(msg_type, 7, data)
    assert raw == JP.encode_step(msg_type, 7, data)
    assert P.frame(P.MSG_HELLO, struct.pack("<I", 2)) == JP.frame(JP.MSG_HELLO,
                                                                  struct.pack("<I", 2))
    for read in (P.read_message_sync, JP.read_message_sync):
        got = read(_Sock(raw + raw))
        assert got == (msg_type, raw[9:])
    for decode in (P.decode_step, JP.decode_step):
        fid, got = decode(raw[9:])
        assert fid == 7
        np.testing.assert_array_equal(got, data)


class _Sock:
    """A blocking socket's recv over fixed bytes."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


_BIG = P.MAX_IMAGE_DIM + 1
MALFORMED_PAYLOADS = {
    "step too short": ("decode_step", b"\x00" * 8),
    "step too long": ("decode_step", b"\x00" * (4 + 4 * 146)),
    "image shorter than its header": ("decode_image", b"\x00" * 12),
    "image beyond MAX_IMAGE_DIM": ("decode_image", struct.pack("<II", 0, 0) + b"\x00" * 24
                                   + struct.pack("<II", _BIG, 1) + b"\x00" * (_BIG * 3)),
    "image dims against payload": ("decode_image", struct.pack("<II", 0, 0) + b"\x00" * 24
                                   + struct.pack("<II", 512, 512) + b"\x00" * (64 * 64 * 3)),
    "image of zero rows": ("decode_image", struct.pack("<II", 0, 0) + b"\x00" * 24
                           + struct.pack("<II", 0, 4)),
}


@pytest.mark.parametrize("case", sorted(MALFORMED_PAYLOADS))
def test_protocol_rejects_malformed_payloads(case):
    """Every malformed payload of JAX's test_protocol_rejects_malformed_payloads
    (and a few more) raises ProtocolError in both packages."""
    fn, payload = MALFORMED_PAYLOADS[case]
    for mod in (P, JP):
        with pytest.raises(mod.ProtocolError):
            getattr(mod, fn)(payload)


MALFORMED_STREAMS = {
    "bad magic": (b"\xde\xad\xbe\xef" * 8, "error"),
    "length beyond MAX_PAYLOAD": (struct.pack("<IBI", P.MAGIC, P.MSG_IMAGE, 0xFFFFFFF0),
                                  "error"),
    "EOF mid-header": (b"\x01\x00", None),
    "EOF mid-payload": (struct.pack("<IBI", P.MAGIC, P.MSG_STEP1, 584) + b"\x00" * 10, None),
}


@pytest.mark.parametrize("case", sorted(MALFORMED_STREAMS))
def test_readers_on_malformed_streams(case):
    """Both readers, blocking and asyncio: bad framing raises
    ProtocolError, a stream cut mid-message reads as EOF (None)."""
    raw, want = MALFORMED_STREAMS[case]

    async def read_async(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await mod.read_message(reader)

    for mod in (P, JP):
        for read in (lambda: mod.read_message_sync(_Sock(raw)),
                     lambda: asyncio.run(read_async(mod))):
            if want == "error":
                with pytest.raises(mod.ProtocolError):
                    read()
            else:
                assert read() is None


# ---------------------------------------------------------------- staged steps

@pytest.fixture(scope="module")
def jax_regs(carried):
    """JAX's StagedRegressors: f32 per (family, sep_view), built once."""
    return {(family, view): JStagedRegressor(carried[family][0], sep_view=view)
            for family, view in STAGED_CASES}


def _peer(seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(2, 126)) * 0.1).astype(np.float32),
            (rng.normal(size=(2, 10)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("family,view", STAGED_CASES)
def test_staged_steps_match_jax(carried, jax_regs, family, view):
    """step1 (uint8 crops normalized on the device, trunk, IEF iter 1 against
    the mean peer) and two step23 calls with explicit peer states, against
    JAX's StagedRegressor on the same weights: atol 1e-4."""
    port = StagedRegressor(carried[family][1], sep_view=view, device="cpu")
    jreg = jax_regs[family, view]
    img, bb = crops(1)
    init = np.stack([INIT_TRANS, INIT_TRANS + 0.5])
    got, want = port.step1(img, bb, init), jreg.step1(img, bb, init)
    assert got.pose.shape == (2, 135) and got.shape.shape == (2, 10)
    np.testing.assert_allclose(got.xf.numpy(), np.asarray(want.xf), atol=1e-4, rtol=1e-4)
    for step in (2, 3):
        np.testing.assert_allclose(got.pose, want.pose, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.shape, want.shape, atol=1e-4, rtol=0)
        art, shape = _peer(step)
        got, want = port.step23(got, bb, art, shape), jreg.step23(want, bb, art, shape)
    np.testing.assert_allclose(got.pose, want.pose, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.shape, want.shape, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port._mean_art, jreg._mean_art)
    np.testing.assert_array_equal(port._mean_shape, jreg._mean_shape)
    for i in (0, 1):
        np.testing.assert_allclose(state_to_wire(got, i), jstate_to_wire(want, i),
                                   atol=1e-4, rtol=0)


def test_staged_int8_matches_jax(carried, capsys):
    """--int8 serving: JAX's regressor calibrates on its first frame batch;
    its int8 weights and scales, carried into the port's regressor, give
    trunk features equal bit for bit to JAX's int8 trunk run op by op on
    the same normalized crops, and the steps' pose within
    tests/test_torch_int8.py's chain bound (MAD < 0.15·RMS) of JAX's staged
    steps. (XLA's fusion inside JAX's jitted step 1 moves some int8
    roundings, so its features are not JAX's op-by-op ones bit for bit.)"""
    variables, model = carried["copenet_twoview"]
    img, bb = crops(2)
    init = np.stack([INIT_TRANS] * 2)
    jreg = JStagedRegressor(variables, int8=True)
    want = jreg.step1(img, bb, init)
    assert "int8 serving calibrated on 2 frame(s)" in capsys.readouterr().out
    reg = StagedRegressor(model, int8=True, device="cpu")
    np_tree = jax.tree_util.tree_map(np.asarray, jreg._qp)
    reg._qp, reg._act_scales, _ = int8_operands_from_jax(np_tree, jreg._act_scales)
    got = reg.step1(img, bb, init)
    eager = jq.resnet50_int8_infer(jreg._qp, jreg._norm_host(img), act_scales=jreg._act_scales)
    np.testing.assert_array_equal(got.xf.numpy(), np.asarray(eager))
    for step in (1, 2):
        dpose = np.abs(got.pose - want.pose)
        assert dpose.mean() < 0.15 * want.pose.std(), (step, dpose.mean())
        art, shape = _peer(4)
        got, want = reg.step23(got, bb, art, shape), jreg.step23(want, bb, art, shape)
    dpose = np.abs(got.pose - want.pose)
    assert dpose.mean() < 0.15 * want.pose.std(), dpose.mean()


def test_staged_int8_calibrates_on_first_frame(carried, capsys):
    """The port's own --int8 path: the first step1 calibrates (and prints the
    clip-rate line), later calls keep that table, and the step-1 pose tracks
    the f32 path within tests/test_serve.py's PTQ bound (mean |Δ| < 0.2·rms)."""
    model = carried["copenet_twoview"][1]
    img, bb = crops(3)
    init = np.stack([INIT_TRANS] * 2)
    base = StagedRegressor(model, device="cpu").step1(img, bb, init)
    q = StagedRegressor(model, int8=True, device="cpu")
    assert q._act_scales is None
    s_q = q.step1(img, bb, init)
    assert len(q._act_scales) == 52
    assert "clip rate max" in capsys.readouterr().out
    assert np.abs(s_q.pose - base.pose).mean() < 0.2 * base.pose.std()
    scales = q._act_scales
    q.step1(img, bb, init)
    assert q._act_scales is scales and capsys.readouterr().out == ""


@pytest.mark.parametrize("family", ["copenet_twoview", SEP])
def test_three_round_protocol_matches_fused(carried, family):
    """The 3-round message exchange with same-frame peers, through
    state_to_wire/wire_to_peer, equals the port's fused two-view forward
    on the same uint8 crops: 1e-5."""
    model = carried[family][1]
    sep = family == SEP
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1, 2, IMG, IMG, 3), dtype=np.uint8)
    bb = (rng.normal(size=(1, 2, 3)) * 0.1).astype(np.float32)
    regs = [StagedRegressor(model, sep_view=v if sep else None, device="cpu") for v in (0, 1)]
    states = [regs[v].step1(img[:, v], bb[:, v], INIT_TRANS[None]) for v in (0, 1)]
    for _ in range(2):
        wires = [state_to_wire(s) for s in states]
        states = [regs[v].step23(states[v], bb[:, v], *(a[None] for a in
                                                         wire_to_peer(wires[1 - v])))
                  for v in (0, 1)]
    x = regs[0]._normalize(torch.from_numpy(img))
    with torch.no_grad():
        fused = model(x, torch.from_numpy(bb),
                      torch.from_numpy(INIT_TRANS * C.TRANS_SCALE).expand(1, 2, 3))
    np.testing.assert_allclose(np.stack([s.pose[0] for s in states]), fused.pose[0].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.stack([s.shape[0] for s in states]),
                               fused.betas[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scene", ["static", "moving"])
def test_lag_one_report_matches_jax(carried, scene):
    """lag_one_report against JAX's on the same normalized frames: each key
    within 1e-4; on a static scene lag-one is the synchronized protocol
    (< 1e-6)."""
    variables, model = carried["copenet_twoview"]
    rng = np.random.default_rng(6)
    static = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32) * 0.1
    drift = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32) * 0.05
    imgs = [static + (f * drift if scene == "moving" else 0) for f in range(4)]
    bbs = [np.zeros((2, 3), np.float32) for _ in range(4)]
    got = lag_one_report(model, imgs, bbs, INIT_TRANS, device="cpu")
    want = jlag_one_report(variables, imgs, bbs, INIT_TRANS)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    if scene == "static":
        assert got["pose_absdiff"] < 1e-6 and got["beta_absdiff"] < 1e-6, got
    else:
        assert 0 < got["pose_absdiff"] < 5.0 * got["frame_motion_pose"], got
