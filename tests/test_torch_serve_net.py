"""The port's servers over TCP on the CPU (airpose_tpu_torch.serve, no JAX):
the server-logic tests of tests/test_serve.py and the native-client tests of
tests/test_native_client.py, held against the port's own fused forward and
staged path. Seed-0 weights, 64² crops.

Tolerances: served results against the fused forward 1e-5 (the staged
protocol with same-frame peers computes the fused forward's operations),
the served-vs-offline benchtest 1e-3 (tests/test_serve.py's; the offline
forward normalizes on the host in f64, the servers on the device in f32),
the native ROI replay 2e-2 (tests/test_native_client.py's: the client's
crops are within one uint8 step of the eval pipeline's)."""

import asyncio
import contextlib
import io
import os
import shutil
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from airpose_tpu_torch import constants as C
from airpose_tpu_torch.data import CopenetRealDataset
from airpose_tpu_torch.data.fake_real import write_fake_real_capture
from airpose_tpu_torch.eval.compile_results import real_batches
from airpose_tpu_torch.models import MODEL_REGISTRY, AirPoseTwoView
from airpose_tpu_torch.serve import benchtest
from airpose_tpu_torch.serve import protocol as P
from airpose_tpu_torch.serve import server as S
from airpose_tpu_torch.serve.staged import StagedRegressor, state_to_wire
from airpose_tpu_torch.train.checkpoint import CheckpointManager
from airpose_tpu_torch.train.state import TrainState, model_variables

IMG = 64
BB = np.asarray([0.0, 0.0, 1.0], np.float32)
INIT_TRANS = np.asarray([0.0, 0.0, 10.0], np.float32)
SEP = "copenet_twoview_sep"


@pytest.fixture(autouse=True)
def _drop_tmp_path(request):
    """Deletes each test's tmp_path when it ends: its checkpoints (~100-400
    MB each) would otherwise stay in the base temps pytest keeps."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return AirPoseTwoView(seed=0)


@pytest.fixture
def reg(model):
    return StagedRegressor(model, device="cpu")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 3-frame synthetic DJI capture and its eval batches at 64²."""
    root = str(tmp_path_factory.mktemp("capture"))
    write_fake_real_capture(root, n=3)
    ds = CopenetRealDataset(root, frame_range=range(0, 3))
    return root, ds, list(real_batches(ds, 3, out_size=IMG, device="cpu"))


def image(rng, size=IMG):
    return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)


def client_request(port, frame_id, img, bb=BB, init_trans=INIT_TRANS):
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(P.encode_image(0, frame_id, bb, init_trans, img))
    msg = P.read_message_sync(sock)
    sock.close()
    assert msg is not None and msg[0] == P.MSG_RESULT
    return P.decode_step(msg[1])


def stop_loop(loop, thread=None):
    """Cancel every task, let the cancellations run their cleanup, then stop
    and close the loop."""

    async def shutdown():
        tasks = [t for t in asyncio.all_tasks(loop) if t is not asyncio.current_task()]
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=5)
        loop.stop()

    asyncio.run_coroutine_threadsafe(shutdown(), loop)
    if thread is not None:
        thread.join(timeout=10)
        assert not thread.is_alive()
    if not loop.is_running() and not loop.is_closed():
        loop.close()


def start_loop(*coroutines):
    """Run ``coroutines`` (factories) as tasks of a new loop on a thread."""
    loop = asyncio.new_event_loop()
    tasks = []

    def run():
        asyncio.set_event_loop(loop)
        tasks.extend(loop.create_task(c()) for c in coroutines)
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.5)
    return loop, t, tasks


def start_server(srv, port):
    return start_loop(lambda: S.run_server(None, srv.robot_id, port, server=srv))[:2]


def degraded(reg, img, bb=BB, init_trans=INIT_TRANS):
    """The 3-round path with the mean-parameter peer in rounds 2 and 3."""
    state = reg.step1(img[None], bb[None], init_trans[None])
    for _ in range(2):
        state = reg.step23(state, bb[None], reg._mean_art, reg._mean_shape)
    return state_to_wire(state)


def test_two_servers_over_tcp_match_fused(model, rng):
    """Two servers on localhost, each fed its view's crop of one frame by a
    client thread, run the 3-round exchange over their peer link: each
    step-3 result equals the fused two-view forward of the frame."""
    ports = benchtest._free_ports(2)
    loop, t, _ = start_loop(
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 1, ports[0],
                             peer_port=ports[1]),
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 2, ports[1],
                             peer_port=ports[0]))
    imgs = [image(rng), image(rng)]
    bbs = (rng.normal(size=(2, 3)) * 0.1).astype(np.float32)
    results, errors = [None, None], []

    def client(v):
        try:
            results[v] = client_request(ports[v], 7, imgs[v], bbs[v])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(v,)) for v in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    stop_loop(loop, t)
    assert not errors and not any(th.is_alive() for th in threads), errors

    x = torch.from_numpy(np.stack([benchtest.normalize_host(i) for i in imgs])[None]).float()
    with torch.no_grad():
        fused = model(x, torch.from_numpy(bbs[None]),
                      torch.from_numpy(INIT_TRANS * C.TRANS_SCALE).expand(1, 2, 3))
    for v in (0, 1):
        fid, data = results[v]
        assert fid == 7 and data.shape == (145,)
        np.testing.assert_allclose(data[:10], fused.betas[0, v].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(data[10:13], fused.pose[0, v, :3].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(data[13:], fused.pose[0, v, 3:].numpy(), atol=1e-5, rtol=0)


def test_degraded_single_server_serves_with_mean_peer(reg, rng):
    """With no peer connected the server answers with the mean-parameter
    peer in rounds 2 and 3 instead of stalling."""
    srv = S.AirPoseServer(reg, robot_id=1, peer_timeout=0.2)
    (port,) = benchtest._free_ports(1)
    loop, lt = start_server(srv, port)
    img = image(rng)
    try:
        fid, data = client_request(port, 3, img)
        assert fid == 3 and np.isfinite(data).all()
        assert srv.peer_timeouts == 2
    finally:
        stop_loop(loop, lt)
    np.testing.assert_allclose(data, degraded(reg, img), atol=1e-5, rtol=0)


def test_malformed_clients_do_not_kill_server(reg, rng):
    """Bad magic, a multi-GB length prefix, an IMAGE whose dims disagree with
    its payload, mid-stream garbage, dims beyond MAX_IMAGE_DIM and a crop
    shape other than the pinned one each get their connection closed, and
    the server still serves a well-formed client afterwards."""
    srv = S.AirPoseServer(reg, robot_id=1, peer_timeout=0.1)
    (port,) = benchtest._free_ports(1)
    loop, lt = start_server(srv, port)

    def expect_closed(raw):
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        sock.sendall(raw)
        sock.settimeout(10)
        assert sock.recv(1) == b""
        sock.close()

    img = image(rng)
    try:
        expect_closed(b"\xde\xad\xbe\xef" * 8)
        expect_closed(struct.pack("<IBI", P.MAGIC, P.MSG_IMAGE, 0xFFFFFFF0))
        bad = bytearray(P.encode_image(0, 1, BB, INIT_TRANS, img))
        struct.pack_into("<II", bad, 9 + 32, 512, 512)
        expect_closed(bytes(bad))
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.sendall(P.encode_image(0, 5, BB, INIT_TRANS, img))
        msg = P.read_message_sync(sock)
        assert msg is not None and msg[0] == P.MSG_RESULT
        sock.sendall(b"\x00" * 16)
        sock.settimeout(10)
        assert sock.recv(1) == b""
        sock.close()
        big = P.MAX_IMAGE_DIM + 1
        hdr = struct.pack("<II", 0, 7) + BB.tobytes() + INIT_TRANS.tobytes()
        expect_closed(P.frame(P.MSG_IMAGE, hdr + struct.pack("<II", big, 1) + b"\x00" * (big * 3)))
        expect_closed(P.encode_image(0, 8, BB, INIT_TRANS, img[:32, :32]))
        fid, data = client_request(port, 9, img)
        assert fid == 9 and np.isfinite(data).all()
    finally:
        stop_loop(loop, lt)


def test_server_stats_logging(reg, rng, capfd):
    """--log-every 1: the served/dropped/peer-timeout counters print every
    served frame, with the recent rate from the second line on."""
    srv = S.AirPoseServer(reg, robot_id=1, peer_timeout=0.05, log_every=1)
    (port,) = benchtest._free_ports(1)
    loop, lt = start_server(srv, port)
    try:
        for f in (0, 1):
            client_request(port, f, image(rng))
    finally:
        stop_loop(loop, lt)
    out = capfd.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("[robot 1]")]
    assert len(lines) == 2, out
    assert "served=1" in lines[0] and "rate=" not in lines[0]
    assert "served=2" in lines[1] and "rate=" in lines[1]
    assert "peer_timeouts=4" in lines[1]


def test_latest_frame_wins_drop_policy(reg, rng):
    """A burst of frames queued behind a slow step 1 is dropped down to the
    newest."""

    class SlowReg:
        _mean_art, _mean_shape = reg._mean_art, reg._mean_shape

        def step1(self, *a):
            time.sleep(0.4)
            return reg.step1(*a)

        def step23(self, *a):
            return reg.step23(*a)

    srv = S.AirPoseServer(SlowReg(), robot_id=1, peer_timeout=0.05)
    (port,) = benchtest._free_ports(1)
    loop, lt = start_server(srv, port)
    img = image(rng)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        for f in range(4):
            sock.sendall(P.encode_image(0, f, BB, INIT_TRANS, img))
        got = []
        for _ in range(2):
            msg = P.read_message_sync(sock)
            assert msg is not None and msg[0] == P.MSG_RESULT
            got.append(P.decode_step(msg[1])[0])
        sock.close()
    finally:
        stop_loop(loop, lt)
    assert got == [0, 3] and srv.frames_dropped == 2


def test_peer_message_pruning(reg):
    """_note_peer keeps at most PEER_PRUNE_HORIZON + 1 frames of each type."""
    srv = S.AirPoseServer(reg, robot_id=1)
    data = np.zeros(145, np.float32)
    for fid in range(100):
        srv._note_peer(P.MSG_STEP1, fid, data)
        srv._note_peer(P.MSG_STEP2, fid, data)
    per_type = srv.PEER_PRUNE_HORIZON + 1
    assert len(srv._peer_msgs) <= 2 * per_type and len(srv._events) <= 2 * per_type
    assert (P.MSG_STEP1, 99) in srv._peer_msgs and (P.MSG_STEP2, 99) in srv._peer_msgs


def test_peer_frame_id_restart_drops_stale_entries(reg):
    srv = S.AirPoseServer(reg, robot_id=1)
    data = np.zeros(145, np.float32)
    for fid in (4999, 5000, 0):  # the peer's client restarted its counter
        srv._note_peer(P.MSG_STEP1, fid, data)
    assert (P.MSG_STEP1, 5000) not in srv._peer_msgs
    assert (P.MSG_STEP1, 4999) not in srv._peer_msgs
    assert (P.MSG_STEP1, 0) in srv._peer_msgs


def test_new_peer_link_clears_previous_runs_state(reg):
    srv = S.AirPoseServer(reg, robot_id=1)
    srv._note_peer(P.MSG_STEP1, 123, np.zeros(145, np.float32))
    assert srv._latest_peer and srv._peer_msgs

    class Writer:
        def close(self):
            pass

    async def drive():
        reader = asyncio.StreamReader()
        reader.feed_eof()  # the link dies right after it opens
        await srv.peer_loop(reader, Writer())

    asyncio.run(drive())
    assert not srv._peer_msgs and not srv._latest_peer and not srv._events
    assert srv.peer_writer is None and not srv._transports


def test_stray_connection_cannot_hijack_peer_link(reg):
    """Only a HELLO-first connection opens the peer link."""
    srv = S.AirPoseServer(reg, robot_id=1, peer_timeout=0.1)
    sentinel = object()
    srv.peer_writer = sentinel  # stands in for a live peer link
    (port,) = benchtest._free_ports(1)
    loop, lt = start_server(srv, port)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        sock.sendall(P.encode_step(P.MSG_RESULT, 0, np.zeros(145, np.float32)))
        sock.settimeout(5)
        assert sock.recv(1) == b""
        sock.close()
        assert srv.peer_writer is sentinel
    finally:
        srv.peer_writer = None
        stop_loop(loop, lt)


def test_max_frames_exits_with_live_peer_link(model, rng):
    """run_server(max_frames=1) returns while the peer link (an accepted
    connection of robot 2's server) is still open."""
    ports = benchtest._free_ports(2)
    loop, t, tasks = start_loop(
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 1, ports[0],
                             peer_port=ports[1], peer_timeout=0.3),
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 2, ports[1],
                             peer_port=ports[0], peer_timeout=0.3, max_frames=1))
    try:
        fid, data = client_request(ports[1], 1, image(rng))
        assert fid == 1 and np.isfinite(data).all()
        deadline = time.time() + 30
        while not tasks[1].done() and time.time() < deadline:
            time.sleep(0.05)
        assert tasks[1].done(), "run_server(max_frames=1) did not exit with a live peer link"
        assert tasks[1].exception() is None
    finally:
        stop_loop(loop, t)


@pytest.mark.parametrize("family", ["copenet_twoview", SEP])
def test_benchtest_served_matches_offline(capture, family):
    """run_benchtest on the 3-frame capture: two in-process servers over
    TCP against the fused offline forward on the same uint8 crops, < 1e-3,
    and a served rate."""
    diffs = benchtest.run_benchtest(MODEL_REGISTRY[family](seed=9), capture[2],
                                    measure_rate=True, rate_warmup=1, startup_wait=0.2,
                                    device="cpu")
    assert diffs.pop("served_fps") > 0
    assert sorted(diffs) == sorted(f"{k}_{m}" for k in ("beta", "trans", "pose")
                                   for m in ("m1", "m2"))
    for k, v in diffs.items():
        assert v < 1e-3, (k, v)


def save_port_ckpt(model, family, directory):
    """``model``'s tensors as the trainer writes them (CheckpointManager),
    with an empty optimizer state."""
    opt = {"count": 0, "mu": {}, "nu": {}, "nu_max": {}}
    CheckpointManager(directory, family).save(
        TrainState(step=3, **model_variables(model), opt_state=opt), "best")
    return os.path.join(directory, "best.ckpt")


@pytest.mark.parametrize("family", ["copenet_twoview", SEP])
def test_server_cli_serves_saved_checkpoint(tmp_path, rng, family):
    """server.main --ckpt on a trainer .ckpt: one frame over TCP (robot 2,
    which serves trunk1/core1 of a _sep checkpoint), answered with the
    degraded 3-round result of the saved weights, then a clean exit
    (--max-frames 1)."""
    model = MODEL_REGISTRY[family](seed=17)
    ckpt = save_port_ckpt(model, family, str(tmp_path))
    (port,) = benchtest._free_ports(1)
    t = threading.Thread(target=S.main, daemon=True, args=([
        "--port", str(port), "--robot-id", "2", "--model", family, "--ckpt", ckpt,
        "--peer-timeout", "0.2", "--max-frames", "1", "--platform", "cpu"],))
    t.start()
    img = image(rng)
    bb = np.asarray([0.05, -0.1, 1.2], np.float32)
    deadline = time.time() + 60
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except OSError:
            assert time.time() < deadline, "server CLI never opened its port"
            time.sleep(0.1)
    sock.sendall(P.encode_image(2, 0, bb, INIT_TRANS, img))
    msg = P.read_message_sync(sock)
    sock.close()
    assert msg is not None and msg[0] == P.MSG_RESULT
    fid, served = P.decode_step(msg[1])
    t.join(timeout=30)
    assert not t.is_alive(), "--max-frames did not stop the server"
    reg = StagedRegressor(model, sep_view=1 if family == SEP else None, device="cpu")
    assert fid == 0
    np.testing.assert_allclose(served, degraded(reg, img, bb), atol=1e-5, rtol=0)


@pytest.mark.parametrize("argv,message", [
    (["--random-init", "--torch-ckpt", "x.ckpt"], "exactly one"),
    ([], "exactly one"),
    (["--ckpt", "{tmp}"], "directory"),
])
def test_server_cli_weight_sources(tmp_path, capsys, argv, message):
    """Exactly one weight source; a directory (an orbax checkpoint) is
    refused."""
    argv = [a.format(tmp=tmp_path) for a in argv]
    with pytest.raises(SystemExit):
        S.main(["--port", "1", "--robot-id", "1", "--platform", "cpu"] + argv)
    assert message in capsys.readouterr().err


def test_benchtest_rate_procs_separate_processes(capture):
    """--rate-procs: the replay served by two `python -m
    airpose_tpu_torch.serve.server` processes on --platform cpu, each
    exiting on its own after the replay (--max-frames); the wire results
    match the offline forward and the rate is measured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        benchtest.main(["--datapath", f"real://{capture[0]}", "--frames", "0", "3",
                        "--random-init", "--batch_size", "3", "--img_res", str(IMG),
                        "--rate", "--rate-warmup", "1", "--rate-procs", "--platform", "cpu"])
    out = buf.getvalue()
    vals = {line.split(": ")[0]: float(line.split(": ")[1])
            for line in out.splitlines() if line.startswith("benchtest_")}
    for m in ("m1", "m2"):
        for k in ("beta", "trans", "pose"):
            assert vals[f"benchtest_absdiff_{k}_{m}"] < 1e-3, out
    assert vals["benchtest_served_fps"] > 0, out


def native_client():
    if not benchtest.ensure_client_built():
        pytest.skip("native client not buildable (no cmake or no C++ compiler)")
    return benchtest._client_binary()


def test_cpp_clients_two_server_sync(model):
    """The unchanged native C++ clients against two port servers at 4 FPS:
    client 1 in ROI mode (full frames + ROI on stdin) with --reproject,
    client 2 in fake mode; every frame gets its RESULT line."""
    client = native_client()
    ports = benchtest._free_ports(2)
    loop, t, _ = start_loop(
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 1, ports[0],
                             peer_port=ports[1]),
        lambda: S.run_server(StagedRegressor(model, device="cpu"), 2, ports[1],
                             peer_port=ports[0]))
    n_frames, W, H = 3, 96, 72
    rng = np.random.default_rng(3)
    roi = np.asarray([10, 60, 70, 12], np.float32)  # gt: box x[12,70] y[10,60]
    roi_stdin = b"".join(roi.tobytes() + rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                         .tobytes() for _ in range(n_frames))
    procs = [subprocess.Popen(
        [client, "--host", "127.0.0.1", "--port", str(ports[v]), "--robot-id", str(v + 1),
         "--frames", str(n_frames), "--fps", "4"]
        + (["--mode", "roi", "--img-w", str(W), "--img-h", str(H), "--px", "48",
            "--py", "36", "--roi-groundtruth", "--reproject", "--src-fx", "80",
            "--src-fy", "80", "--dst-fx", "64", "--dst-fy", "64", "--dst-w", "80",
            "--dst-h", "60"] if v == 0 else []),
        stdin=subprocess.PIPE if v == 0 else None, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for v in (0, 1)]
    outs = []
    try:
        for v, p in enumerate(procs):
            out, err = p.communicate(input=roi_stdin if v == 0 else None, timeout=180)
            assert p.returncode == 0, (out, err)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        stop_loop(loop, t)
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("RESULT")]
        assert len(lines) == n_frames, out
        for i, line in enumerate(lines):
            assert f"frame={i} " in line
        assert "trans=" in lines[0] and "pose0=" in lines[0]


def test_benchtest_native_roi_replay(capture):
    """The capture's full 1920×1080 frames and ROI messages through the
    native C++ clients (which crop, resize and encode bb themselves), two
    port servers, against the offline forward on the eval pipeline's own
    crops: < 2e-2."""
    native_client()
    _, ds, batches = capture
    diffs = benchtest.run_benchtest(AirPoseTwoView(seed=9), batches, native_roi=ds,
                                    startup_wait=0.2, device="cpu")
    assert len(diffs) == 6
    for k, v in diffs.items():
        assert v < 2e-2, (k, v)
