"""Served-vs-offline benchtest (port of airpose_tpu/serve/benchtest.py).

The reference validated its deployed client/server pipeline by replaying
rosbags through two localhost client+server pairs and diffing the recorded
`step3_pub` messages against offline `trainer.test` predictions
(ref copenet_real/scripts/copenet_real_res_compile.py:193-296 — six printed
mean-abs diffs: β, translation, 6D pose per machine). This tool is that
check as a first-class command: it replays frames from a real-layout
capture through TWO live servers speaking the 3-round protocol and diffs
each step3 result against the fused offline forward on the same crops.

Both paths consume the SAME uint8 crop (the wire format is 8-bit), so the
residual diff isolates the protocol/staging path; with same-frame peer
messages the staged math is identical to the fused forward (the lag-one
in-flight regime is deliberately different — SURVEY.md §7).

The offline reference is this package's fused f32 forward on the same
uint8 crops and the same device. ``--rate-procs`` starts the two server
processes on the benchtest's own ``--platform``: two processes share one
CUDA card, so on the card it measures the card (the JAX package pins them
to the CPU, since two processes cannot share its one TPU).

Usage:
  python -m airpose_tpu_torch.serve.benchtest --datapath real:///path \
      --frames 0 64 [--ckpt last.ckpt | --random-init] [--platform cpu]
"""

import argparse
import asyncio
import glob
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device
from . import protocol as P
from .staged import StagedRegressor, normalize_host

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_ports(n: int) -> List[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _denormalize_u8(img: np.ndarray) -> np.ndarray:
    """Normalized f32 crop → the uint8 image a client would send."""
    x = img * np.asarray(C.IMG_NORM_STD) + np.asarray(C.IMG_NORM_MEAN)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _client_binary() -> str:
    path = os.path.join(REPO, "native", "build", "airpose_client")
    if not os.path.exists(path):
        raise RuntimeError(
            "native client not built — run: cmake -S native -B native/build "
            "&& cmake --build native/build")
    return path


def ensure_client_built(targets=("airpose_client",)) -> bool:
    """Build the native binaries if any of ``targets`` is missing; False if
    no toolchain or the build fails. The single cmake recipe for every
    caller (benchtest --native-roi, the e2e tests)."""
    build = os.path.join(REPO, "native", "build")

    def _all_built():
        return all(os.path.exists(os.path.join(build, t)) for t in targets)

    if _all_built():
        return True
    if shutil.which("cmake") is None:
        return False
    native = os.path.join(REPO, "native")
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    try:
        subprocess.run(["cmake", "-S", native, "-B", build] + gen,
                       check=True, capture_output=True)
        subprocess.run(["cmake", "--build", build],
                       check=True, capture_output=True)
    except subprocess.CalledProcessError:
        return False
    # drop cmake's compiler-id probe SOURCES: they are generated C++ that
    # line counters mistake for project code (they sit under the
    # gitignored build dir; the cmake cache does not need them after
    # configure)
    for probe in glob.glob(os.path.join(
            build, "CMakeFiles", "*", "CompilerId*", "CMake*CompilerId.cpp")):
        os.unlink(probe)
    return _all_built()


def _spawn_server_procs(ports: List[int], n_frames: int,
                        server_cli_args: List[str], platform: str):
    """Two `python -m airpose_tpu_torch.serve.server` OS processes — the
    reference's actual deployment topology (one server per drone machine,
    ref README.md:221-223) instead of two coroutines on one event loop.
    Both serve on ``platform`` (two processes share one CUDA card) and
    exit on their own after ``n_frames`` via --max-frames. Returns
    (procs, log_paths)."""
    env = dict(os.environ)
    # append to PYTHONPATH, keeping what the caller's environment set
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    for port, peer, rid in ((ports[0], ports[1], 1),
                            (ports[1], ports[0], 2)):
        fd, log = tempfile.mkstemp(suffix=f"_server{rid}.log")
        logs.append(log)
        cmd = [sys.executable, "-m", "airpose_tpu_torch.serve.server",
               "--port", str(port), "--peer-port", str(peer),
               "--robot-id", str(rid), "--platform", platform,
               "--max-frames", str(n_frames)] + list(server_cli_args)
        procs.append(subprocess.Popen(
            cmd, stdout=fd, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        os.close(fd)
    return procs, logs


def run_benchtest(
    model,
    batches: List[Dict],
    startup_wait: float = 1.5,
    int8: bool = False,
    measure_rate: bool = False,
    rate_warmup: int = 4,
    native_roi=None,
    server_cli_args=None,
    device=None,
) -> Dict[str, float]:
    """Replay every frame of ``batches`` (finished real eval batches) through
    two live servers of ``model`` (an AirPoseTwoView, or an
    AirPoseTwoViewSep whose drone v serves its own weight copy), then
    compare step3 wire results against the fused offline forward of
    ``model`` on ``device`` (CUDA by default). Returns the six reference
    diffs.

    ``int8`` serves with the quantized trunk (the --int8 deployment
    configuration) while the offline forward stays f32 — the diffs then
    quantify exactly what int8 serving costs in the wire format.

    ``measure_rate`` additionally reports end-to-end served frames/s
    through the live TCP 3-round pipeline (per drone pair; frames after
    ``rate_warmup`` so first-call set-up is excluded) — the counterpart of
    the reference's quoted 4 FPS for the synchronized pipeline
    (ref README.md final paragraph). Note both servers share one card; a
    real deployment gives each drone its own, so this under-reports the
    two-drone rate.

    ``native_roi`` (a CopenetRealDataset) replaces the Python replay
    clients with the NATIVE C++ clients in ROI mode: the capture's FULL
    frames plus the eval pipeline's keypoint-extent crop boxes (as
    groundtruth-mode NeuralNetworkFeedback ROIs) stream over stdin, and
    the clients do the crop/resize/bb themselves — the complete replica
    of the reference's rosbag replay through its ROS client
    (ref README.md demo instructions). The residual diffs then cover the
    client-side image path too (bounded by the ≤1-uint8-step crop parity,
    tests/test_native_client.py). ``server_cli_args`` serves from two
    server processes with those extra arguments instead (``--rate-procs``)."""
    from .server import run_server

    dev = resolve_device(device)
    model = model.to(dev)
    sep = hasattr(model, "trunk0")
    if measure_rate and native_roi is not None:
        raise ValueError("--rate needs the Python replay clients (the C++ "
                         "client reports per-frame latency on stdout "
                         "instead)")

    # ---- collect frames: uint8 crops + bb per view ----
    imgs_u8, bbs = [], []
    for b in batches:
        img = b["images"].cpu().numpy()  # (B, 2, S, S, 3) normalized
        bb = b["bb"].cpu().numpy()
        valid = int(b.get("_valid", img.shape[0]))  # skip tail-pad rows
        for i in range(valid):
            imgs_u8.append([_denormalize_u8(img[i, v]) for v in (0, 1)])
            bbs.append(bb[i])
    n = len(imgs_u8)
    init_trans = np.asarray([0.0, 0.0, 10.0], np.float32)

    # ---- servers: in-process event loop OR separate OS processes ----
    ports = _free_ports(2)
    serve_error: List[Exception] = []
    loop = server_thread = None
    procs, proc_logs = [], []
    if server_cli_args is not None:
        procs, proc_logs = _spawn_server_procs(ports, n, server_cli_args, dev.type)

        def _server_died():
            return any(p.poll() not in (None, 0) for p in procs)
    else:
        loop = asyncio.new_event_loop()

        def serve():
            try:
                asyncio.set_event_loop(loop)
                regs = [StagedRegressor(model, sep_view=v if sep else None,
                                        int8=int8, device=dev) for v in (0, 1)]
                loop.create_task(run_server(regs[0], 1, ports[0], peer_port=ports[1]))
                loop.create_task(run_server(regs[1], 2, ports[1], peer_port=ports[0]))
                loop.run_forever()
            except Exception as e:  # surfaced to the clients below
                serve_error.append(e)

        def _server_died():
            return bool(serve_error)

        server_thread = threading.Thread(target=serve, daemon=True)
        server_thread.start()
    time.sleep(startup_wait)

    served = [np.zeros((n, C.WIRE_NUM_FLOATS), np.float32) for _ in (0, 1)]
    done_t = [np.zeros(n) for _ in (0, 1)]  # per-frame completion stamps
    errors: List[Exception] = []

    def _connect(port):
        # regressor construction (int8 trunk quantization, a server
        # process's imports and weight loading) can outlast startup_wait —
        # retry until the server binds or provably died, with the same
        # generous bound as the post-connect read timeout below
        deadline = time.time() + 600
        while True:
            try:
                return socket.create_connection(("127.0.0.1", port), timeout=60)
            except OSError:
                if _server_died() or time.time() > deadline:
                    raise
                time.sleep(0.25)

    def client(v):
        try:
            sock = _connect(ports[v])
            # the first frame includes the kernels' build (nvcc) and the
            # int8 calibration
            sock.settimeout(600)
            for f in range(n):
                sock.sendall(P.encode_image(
                    v, f, bbs[f][v], init_trans, imgs_u8[f][v]
                ))
                msg = P.read_message_sync(sock)
                if msg is None or msg[0] != P.MSG_RESULT:
                    raise RuntimeError(f"server {v + 1} answered frame {f} with {msg!r}")
                fid, data = P.decode_step(msg[1])
                served[v][fid] = data
                done_t[v][f] = time.perf_counter()
            sock.close()
        except Exception as e:  # surfaced below
            errors.append(e)

    def native_client(v):
        """Drive the C++ client over the capture's full frames (ROI mode).

        Frames stream to the subprocess one at a time (the client reads
        frame-by-frame, so stdin backpressure keeps ~one frame in flight)
        instead of materializing the whole multi-hundred-MB replay in
        memory."""
        try:
            import cv2

            from ..data.real import person_crop_box

            ds = native_roi
            if getattr(ds, "shuffle_cams", False):
                raise ValueError("native-roi replay needs a fixed camera order")
            # view → camera mapping must match the offline batches
            # (host_batch pins the order from first_cam)
            cam = (1 - v) if getattr(ds, "first_cam", 0) == 1 else v
            size = imgs_u8[0][v].shape[0]
            px = float(ds.intr[cam][0, 2])
            py = float(ds.intr[cam][1, 2])
            # the clamp bound must be the capture's ACTUAL frame size (the
            # offline host_batch clamps the same way) — a downsampled
            # capture is smaller than the nominal 1920×1080
            frame_w, frame_h = ds.frame_wh
            fd, dump = tempfile.mkstemp(suffix=".bin")
            os.close(fd)
            try:
                proc = subprocess.Popen(
                    [_client_binary(), "--host", "127.0.0.1",
                     "--port", str(ports[v]), "--robot-id", str(v + 1),
                     "--frames", str(n), "--fps", "0", "--size", str(size),
                     "--mode", "roi", "--img-w", str(frame_w),
                     "--img-h", str(frame_h), "--px", str(px),
                     "--py", str(py), "--roi-groundtruth",
                     "--dump-results", dump],
                    stdin=subprocess.PIPE,
                    stdout=subprocess.DEVNULL,  # per-frame latency lines
                    stderr=subprocess.PIPE,
                )
                try:
                    for idx in range(n):
                        x0, y0, x1, y1 = person_crop_box(
                            ds.opose[cam, idx], ds.frame_wh)
                        path = ds.image_paths[cam][idx]
                        img = cv2.imread(path)
                        if img is None:
                            raise FileNotFoundError(
                                f"native-roi replay: frame unreadable: {path}")
                        if (img.shape[1], img.shape[0]) != (frame_w, frame_h):
                            raise ValueError(
                                f"mixed frame sizes: {path} is "
                                f"{img.shape[1]}x{img.shape[0]}, capture is "
                                f"{frame_w}x{frame_h}")
                        # groundtruth-mode ROI field mapping:
                        # {ymin, ymax, xcenter=xmax, ycenter=xmin}
                        try:
                            proc.stdin.write(struct.pack("<4f", y0, y1, x1, x0))
                            proc.stdin.write(
                                np.ascontiguousarray(img[..., ::-1]).tobytes())
                        except BrokenPipeError:
                            raise RuntimeError(
                                f"native client {v} exited early: "
                                f"{proc.stderr.read().decode()}")
                    proc.stdin.close()
                    stderr = proc.stderr.read()
                    if proc.wait(timeout=900) != 0:
                        raise RuntimeError(
                            f"native client {v} failed: {stderr.decode()}")
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                rec = np.fromfile(dump, dtype=np.dtype(
                    [("fid", "<u4"), ("data", "<f4", C.WIRE_NUM_FLOATS)]))
                if rec.shape[0] != n:
                    raise RuntimeError(f"native client {v} dumped {rec.shape[0]} "
                                       f"results for {n} frames")
                served[v][rec["fid"]] = rec["data"]
            finally:
                os.unlink(dump)
        except Exception as e:  # surfaced below
            errors.append(e)

    client_fn = client if native_roi is None else native_client
    threads = [threading.Thread(target=client_fn, args=(v,)) for v in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    # a thread still alive after the bounded join means the replay never
    # finished — its exception, if any, lands AFTER the errors check
    # below, and the served[] rows it hasn't written are still zero;
    # computing "diffs" from that would print plausible-looking garbage as
    # a success
    if any(t.is_alive() for t in threads):
        errors.append(RuntimeError(
            "benchtest client thread still running after 600 s join — "
            "aborting instead of reporting diffs against unfinished "
            "served results"))
    if procs:
        # --max-frames n makes each server exit on its own once its replay
        # is served; a nonzero exit (or a forced kill) surfaces its log
        for rid, p in enumerate(procs, start=1):
            try:
                rc = p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            if rc != 0:
                with open(proc_logs[rid - 1]) as f:
                    tail = f.read()[-2000:]
                errors.append(RuntimeError(
                    f"server process {rid} exited {rc}:\n{tail}"))
        for log in proc_logs:
            if os.path.exists(log):
                os.unlink(log)
    else:
        # graceful shutdown: cancel the server coroutines BEFORE stopping
        # the loop, then close it from its own thread — a bare stop()
        # leaves client_loop tasks awaiting q.get() on a closed loop (the
        # "Event loop is closed" unraisable in test runs)
        async def _shutdown():
            tasks = [t for t in asyncio.all_tasks(loop)
                     if t is not asyncio.current_task()]
            for task in tasks:
                task.cancel()
            # wait (bounded) for the cancellations to finish their cleanup
            # — closing the TCP servers takes extra loop iterations; the
            # bound keeps a stuck handler from leaving the loop forever
            if tasks:
                await asyncio.wait(tasks, timeout=5)
            loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), loop)
        server_thread.join(timeout=10)
        if not loop.is_running() and not loop.is_closed():
            loop.close()
    if serve_error:
        raise RuntimeError("benchtest server failed") from serve_error[0]
    if errors:
        raise RuntimeError(f"benchtest client failed: {errors}")

    rate = {}
    if measure_rate:
        w = max(1, min(rate_warmup, n - 1))
        fps = [(n - w) / max(done_t[v][n - 1] - done_t[v][w - 1], 1e-9)
               for v in (0, 1)]
        rate["served_fps"] = float(np.mean(fps))

    # ---- offline fused forward over the same uint8 crops ----
    x = torch.from_numpy(np.stack(
        [[normalize_host(imgs_u8[f][v]) for v in (0, 1)] for f in range(n)]
    )).float().to(dev)
    bb = torch.from_numpy(np.stack(bbs)).to(dev)
    pos = torch.from_numpy(init_trans * C.TRANS_SCALE).to(dev).expand(n, 2, 3)
    with torch.inference_mode():
        out = model(x, bb, pos, iters=C.NUM_ITERS)
    off_pose = out.pose.cpu().numpy()   # (n, 2, 135) [scaled trans | 6D]
    off_betas = out.betas.cpu().numpy()

    # ---- the six reference diffs (ref :286-291), unscaled translation ----
    diffs = {}
    for v, name in ((0, "m1"), (1, "m2")):
        diffs[f"beta_{name}"] = float(
            np.abs(served[v][:, :10] - off_betas[:, v]).mean()
        )
        diffs[f"trans_{name}"] = float(
            np.abs(served[v][:, 10:13] / C.TRANS_SCALE
                   - off_pose[:, v, :3] / C.TRANS_SCALE).mean()
        )
        diffs[f"pose_{name}"] = float(
            np.abs(served[v][:, 13:] - off_pose[:, v, 3:]).mean()
        )
    diffs.update(rate)
    return diffs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datapath", required=True, help="real://<dir> or <dir>")
    p.add_argument("--frames", type=int, nargs=2, default=(0, 32))
    p.add_argument("--model", default="copenet_twoview",
                   choices=("copenet_twoview", "copenet_twoview_sep"))
    p.add_argument("--ckpt", default=None,
                   help="this package's trainer .ckpt file (a directory is refused)")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference Lightning .ckpt, loaded strict")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--img_res", type=int, default=224)
    p.add_argument("--int8", action="store_true",
                   help="serve with the int8 PTQ trunk; the offline "
                        "reference stays f32, so the printed diffs ARE "
                        "the deployed quantization cost")
    p.add_argument("--rate", action="store_true",
                   help="also measure end-to-end served frames/s through "
                        "the live 3-round pipeline (per drone pair, "
                        "post-warmup; the reference's 4-FPS counterpart)")
    p.add_argument("--rate-warmup", type=int, default=4,
                   help="frames excluded from --rate (first-call set-up)")
    p.add_argument("--rate-procs", action="store_true",
                   help="serve from two SEPARATE OS processes (python -m "
                        "airpose_tpu_torch.serve.server on this --platform; "
                        "two processes share one CUDA card) instead of two "
                        "coroutines in this process: the reference's actual "
                        "deployment topology (one server per drone machine, "
                        "ref README.md:221-223). Use with --rate to measure "
                        "served FPS without the in-process device-call "
                        "overlap")
    p.add_argument("--native-roi", action="store_true",
                   help="replay through the NATIVE C++ clients in ROI mode "
                        "(full frames + crop boxes over stdin; the clients "
                        "do crop/resize/bb) instead of the Python replay — "
                        "the complete analog of the reference's rosbag "
                        "replay through its ROS client; requires the built "
                        "native/build/airpose_client")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (default: the CUDA device; raises without one)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    from ..data import CopenetRealDataset
    from ..eval.compile_results import real_batches
    from .server import load_served_model

    path = (args.datapath[len("real://"):]
            if args.datapath.startswith("real://") else args.datapath)
    model = load_served_model(p, args, dev)
    ds = CopenetRealDataset(path, frame_range=range(*args.frames))

    B = min(args.batch_size, len(ds))
    batches = list(real_batches(ds, B, out_size=args.img_res, device=dev))
    server_cli_args = None
    if args.rate_procs:
        server_cli_args = ["--model", args.model]
        if args.ckpt:
            server_cli_args += ["--ckpt", os.path.abspath(args.ckpt)]
        if args.torch_ckpt:
            server_cli_args += ["--torch-ckpt",
                                os.path.abspath(args.torch_ckpt)]
        if args.random_init:
            server_cli_args += ["--random-init"]
        if args.int8:
            server_cli_args += ["--int8"]
    diffs = run_benchtest(
        model, batches, int8=args.int8,
        measure_rate=args.rate, rate_warmup=args.rate_warmup,
        native_roi=ds if args.native_roi else None,
        server_cli_args=server_cli_args, device=dev,
    )
    for k, v in diffs.items():
        if k == "served_fps":
            print(f"benchtest_{k}: {v:.2f}")
        else:
            print(f"benchtest_absdiff_{k}: {v:.6f}")


if __name__ == "__main__":
    main()
