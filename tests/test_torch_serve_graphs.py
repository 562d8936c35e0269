"""The served rounds as CUDA graphs (serve/staged.py): on a card each
``StagedRegressor`` round runs eagerly at the first call of its input
shape, is captured at the second and replayed from then on. The tests
marked ``cuda`` hold replayed rounds to eager ones on the same inputs (the
int8 features bit for bit, the 145 wire floats within 1e-6), two
regressors capturing and replaying on two threads at once, a state held
across later calls (serve/lagone.py's pattern), a new crop shape and the
counters; they skip where no CUDA device is present. On the CPU every call
runs eagerly, and the rounds give what the trunk and one IEF step give."""

import threading

import numpy as np
import pytest
import torch

from airpose_tpu_torch import constants as C
from airpose_tpu_torch.models import MODEL_REGISTRY
from airpose_tpu_torch.models.airpose import _regress_step
from airpose_tpu_torch.ops import int8_conv
from airpose_tpu_torch.serve.staged import StagedRegressor, state_to_wire, wire_to_peer

WIRE_ATOL = 1e-6
INIT = np.asarray([[0.0, 0.0, 10.0]], np.float32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    return MODEL_REGISTRY["copenet_twoview"](seed=0)


def frames(seed, n, img=224):
    """n single-crop frames: (uint8 (1, img, img, 3), bb (1, 3), peer
    (art (1, 126), shape (1, 10))) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (1, img, img, 3), dtype=np.uint8),
             (rng.normal(size=(1, 3)) * 0.1).astype(np.float32),
             ((rng.normal(size=(1, 126)) * 0.1).astype(np.float32),
              (rng.normal(size=(1, 10)) * 0.1).astype(np.float32)))
            for _ in range(n)]


def three_rounds(reg, frame):
    """step 1 and two step23 calls: (features, the three rounds' wires)."""
    img, bb, (art, shape) = frame
    s = reg.step1(img, bb, INIT)
    xf, wires = s.xf.clone(), [state_to_wire(s)]
    for _ in (2, 3):
        s = reg.step23(s, bb, art, shape)
        wires.append(state_to_wire(s))
    return xf, np.stack(wires)


def eager_rounds(reg, frame):
    """The same rounds, each the first call of its shape (so eager)."""
    reg._rounds.clear()
    img, bb, (art, shape) = frame
    s = reg.step1(img, bb, INIT)
    xf, wires = s.xf.clone(), [state_to_wire(s)]
    for _ in (2, 3):
        reg._rounds.clear()
        s = reg.step23(s, bb, art, shape)
        wires.append(state_to_wire(s))
    return xf, np.stack(wires)


def twin(reg, model, device):
    """A regressor of the same model holding ``reg``'s int8 weights and
    scales, for eager rounds beside ``reg``'s replays."""
    other = StagedRegressor(model, int8=reg.int8, device=device)
    if reg.int8:
        other._qp, other._act_scales = reg._qp, reg._act_scales
    return other


def assert_same_rounds(got, want, int8):
    (xf, wires), (xf_want, wires_want) = got, want
    if int8:
        assert torch.equal(xf, xf_want)
    np.testing.assert_allclose(wires, wires_want, atol=WIRE_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
def test_replayed_rounds_match_eager(cuda, model, int8):
    """Frames 2-4 of one regressor are replays (frame 2's capture among
    them); each agrees with eager rounds of the same inputs."""
    reg = StagedRegressor(model, int8=int8, device=cuda)
    fs = frames(1, 4)
    three_rounds(reg, fs[0])
    eager = twin(reg, model, cuda)
    for f in fs[1:]:
        assert_same_rounds(three_rounds(reg, f), eager_rounds(eager, f), int8)
    assert reg.eager_calls == 2 and reg.graph_replays == 10


@pytest.mark.cuda
def test_two_regressors_capture_on_two_threads(cuda, model):
    """Two drones' regressors calibrate, capture and replay on two threads
    at once; each thread's rounds agree with eager rounds of its inputs."""
    regs = [StagedRegressor(model, int8=True, device=cuda) for _ in (0, 1)]
    fs = [frames(10 + d, 6) for d in (0, 1)]
    out = [[], []]
    errors = []
    start = threading.Barrier(2)

    def drone(d):
        try:
            start.wait(timeout=60)
            for f in fs[d]:
                out[d].append(three_rounds(regs[d], f))
        except Exception as e:  # read below
            errors.append(e)

    threads = [threading.Thread(target=drone, args=(d,)) for d in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for d in (0, 1):
        assert regs[d].eager_calls == 2 and regs[d].graph_replays == 16
        eager = twin(regs[d], model, cuda)
        for f, got in zip(fs[d], out[d]):
            assert_same_rounds(got, eager_rounds(eager, f), True)


@pytest.mark.cuda
def test_held_state_keeps_its_features(cuda, model):
    """lagone's pattern: one regressor serves both views, so view 0's state
    is held across view 1's replayed step 1 and then goes on to step 2."""
    reg = StagedRegressor(model, int8=True, device=cuda)
    fs = frames(20, 3)
    three_rounds(reg, fs[0])
    three_rounds(reg, fs[0])
    img, bb, (art, shape) = fs[1]
    held = reg.step1(img, bb, INIT)
    kept = held.xf.clone()
    reg.step1(fs[2][0], fs[2][1], INIT)
    assert torch.equal(held.xf, kept)
    got = state_to_wire(reg.step23(held, bb, art, shape))
    want = state_to_wire(twin(reg, model, cuda).step23(held, bb, art, shape))
    np.testing.assert_allclose(got, want, atol=WIRE_ATOL, rtol=0)


@pytest.mark.cuda
def test_new_crop_shape_gets_its_own_graph(cuda, model):
    """A crop of another size runs eagerly once, then has a step-1 graph of
    its own beside the first; both shapes keep replaying right."""
    reg = StagedRegressor(model, int8=True, device=cuda)
    big, small = frames(30, 3), frames(31, 3, img=160)
    for f in big[:2]:
        three_rounds(reg, f)
    eager = twin(reg, model, cuda)
    calls = reg.eager_calls
    for f in small:
        assert_same_rounds(three_rounds(reg, f), eager_rounds(eager, f), True)
    assert reg.eager_calls == calls + 1
    graphs = [k for k, r in reg._rounds.items() if r is not None]
    assert sorted(k[0] for k in graphs) == ["step1", "step1", "step23"]
    assert_same_rounds(three_rounds(reg, big[2]), eager_rounds(eager, big[2]), True)


@pytest.mark.cuda
def test_counters_and_host_launches(cuda, model):
    """The first call of a shape is eager, every later call a replay; the
    int8 conv's host counter advances at the eager call (calibration, the
    clip report and the step) and at the capture, and not at a replay."""
    reg = StagedRegressor(model, int8=True, device=cuda)
    img, bb, (art, shape) = frames(40, 1)[0]
    counts = []
    for _ in range(4):
        n = int8_conv.launches
        reg.step1(img, bb, INIT)
        counts.append(int8_conv.launches - n)
    assert counts == [3 * 52, 52, 0, 0]
    assert (reg.eager_calls, reg.graph_replays) == (1, 3)
    s = reg.step1(img, bb, INIT)
    for _ in range(3):
        reg.step23(s, bb, art, shape)
    assert (reg.eager_calls, reg.graph_replays) == (2, 6)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_cpu_rounds_are_eager_and_unchanged(model, int8):
    """On the CPU every call is eager, nothing is captured, and step 1 and
    step 2 give exactly what the trunk and one IEF step give."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        reg = StagedRegressor(model, int8=int8, device="cpu")
        (img, bb, (art, shape)), = frames(50, 1, img=64)
        for _ in range(2):
            s1 = reg.step1(img, bb, INIT)
            s2 = reg.step23(s1, bb, art, shape)
        assert (reg.eager_calls, reg.graph_replays) == (4, 0)
        assert all(r is None for r in reg._rounds.values())
        with torch.inference_mode():
            x = reg._normalize(torch.tensor(img))
            xf = reg._features(x)
            mean_pose, mean_shape = reg._mean_pose_d, reg._mean_shape_d
            pose = torch.cat([torch.from_numpy(INIT) * C.TRANS_SCALE, mean_pose], dim=-1)
            p1, b1 = _regress_step(model.core, xf, torch.from_numpy(bb), pose, mean_shape,
                                   mean_pose[:, 6:], mean_shape)
            p2, b2 = _regress_step(model.core, xf, torch.from_numpy(bb), p1, b1,
                                   torch.from_numpy(art), torch.from_numpy(shape))
        assert torch.equal(s1.xf, xf)
        for got, want in ((s1.pose, p1), (s1.shape, b1), (s2.pose, p2), (s2.shape, b2)):
            np.testing.assert_array_equal(got, want.numpy())
        art_w, shape_w = wire_to_peer(state_to_wire(s2))
        assert art_w.shape == (126,) and shape_w.shape == (10,)
    finally:
        torch.set_num_threads(torch_threads)
