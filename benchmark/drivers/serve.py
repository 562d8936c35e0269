"""A served drone pair: two drone servers (``serve.server.run_server``,
robot ids 1 and 2, each over its own ``StagedRegressor``) in this process
on free localhost ports, and two replay clients that speak the wire
(``benchmark/wire.py``) and send one uint8 crop per drone per frame.

The loop is open: frame k is due at t0 + k / rate, as a camera triggers
both drones, and both crops are sent at their due time whatever is still
in flight. A frame's latency runs from its due time to the later of its two
drones' step-3 results at the clients; a frame that gets no result (a
server dropped it from its backlog) counts as infinitely late. The window
waits for the last frame due, at most a minute past its close. The
window's frames are those due in it.

Set-up builds the model from the seed's weights, the two servers and
clients, and serves ``warmup_frames`` frames (the first calibrates each
drone's int8 trunk on its own crop). The check runs the plain reference,
the two-view int8 forward with the same-frame peer state, over the pool's
frames, and compares each drone's 145 wire floats of every frame of the
window that both drones served.
"""

import asyncio
import dataclasses
import math
import socket
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import wire
from ..harness import Check, Window
from ..reference import int8 as ref_int8
from ..reference import model as ref
from ..reference.weights import make_state
from . import program_model

# The mean pose and shape every drone's IEF starts from: a raw file that
# both the program and the reference read.
MEAN_PARAMS = (Path(__file__).resolve().parents[2] / "airpose_tpu_torch" / "data" / "assets"
               / "smpl_mean_params.npz")
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
WAIT_AFTER_CLOSE = 60.0


def free_ports(n: int) -> List[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@dataclasses.dataclass
class Pool:
    crops: np.ndarray      # (F, 2, S, S, 3) uint8
    bb: np.ndarray         # (F, 2, 3) float32
    trans: np.ndarray      # (F, 2, 3) float32, unscaled metres


def make_pool(seed: int, frames: int, crop: int) -> Pool:
    """``frames`` distinct frames of two uint8 crops, crop boxes and
    translation starts, drawn on the host (the client's side) from the seed."""
    g = torch.Generator().manual_seed(seed)
    crops = torch.randint(0, 256, (frames, 2, crop, crop, 3), generator=g, dtype=torch.uint8)
    bb = torch.cat([0.1 * torch.randn((frames, 2, 2), generator=g),
                    0.3 + 0.4 * torch.rand((frames, 2, 1), generator=g)], dim=-1)
    trans = torch.cat([0.3 * torch.randn((frames, 2, 2), generator=g),
                       8.0 + 4.0 * torch.rand((frames, 2, 1), generator=g)], dim=-1)
    return Pool(crops.numpy(), bb.numpy(), trans.numpy())


@dataclasses.dataclass
class State:
    loop: asyncio.AbstractEventLoop
    thread: threading.Thread
    servers: list          # the two AirPoseServer objects
    tasks: list            # their run_server tasks, then the clients' readers
    writers: list
    pool: Pool
    arrived: Dict = dataclasses.field(default_factory=dict)   # (drone, frame) → (t, wire)
    events: Dict = dataclasses.field(default_factory=dict)    # frame → asyncio.Event
    next_frame: int = 0
    window: Optional[dict] = None
    due_next: float = 0.0

    def run(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)


def _frame_pool_index(st: State, f: int) -> int:
    return f % len(st.pool.crops)


async def _send(st: State, f: int) -> None:
    i = _frame_pool_index(st, f)
    for d in (0, 1):
        st.writers[d].write(wire.encode_image(d + 1, f, st.pool.bb[i, d], st.pool.trans[i, d],
                                              st.pool.crops[i, d]))
    await asyncio.gather(*(w.drain() for w in st.writers))


async def _read(st: State, d: int, reader) -> None:
    while True:
        msg = await wire.read_message(reader)
        if msg is None:
            return
        if msg[0] != wire.MSG_RESULT:
            continue
        f, data = wire.decode_step(msg[1])
        st.arrived[(d, f)] = (time.perf_counter(), data)
        if (1 - d, f) in st.arrived:
            st.events.setdefault(f, asyncio.Event()).set()


async def _both(st: State, f: int, timeout: float) -> bool:
    ev = st.events.setdefault(f, asyncio.Event())
    try:
        await asyncio.wait_for(ev.wait(), timeout)
        return True
    except asyncio.TimeoutError:
        return False


def setup(ctx) -> State:
    from airpose_tpu_torch.models.airpose import AirPoseTwoView
    from airpose_tpu_torch.serve.server import AirPoseServer, run_server
    from airpose_tpu_torch.serve.staged import StagedRegressor

    s, dev = ctx.sizes, ctx.device
    ctx.phase("imports")
    weights = make_state(ctx.cfg, ctx.seed_of(1), dev)
    ctx.phase("weights")
    model = program_model(AirPoseTwoView, weights, dev, torch.float32)
    ctx.phase("model")
    pool = make_pool(ctx.seed_of(3), s["pool_frames"], s["crop"])
    regs = [StagedRegressor(model, int8=s["trunk"] == "int8", device=dev) for _ in (0, 1)]
    ctx.phase("inputs_and_quantize")
    ports = free_ports(2)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.call_soon(started.set)
        loop.run_forever()

    thread = threading.Thread(target=serve, name="drone-pair", daemon=True)
    thread.start()
    started.wait()
    # a bounded run (max_frames) waits on the server's own ``done`` rather than
    # serving forever; shutdown lowers the bound to end it cleanly
    st = State(loop, thread, [AirPoseServer(regs[d], d + 1, max_frames=1 << 62)
                              for d in (0, 1)], [], [], pool)

    async def start():
        ready = [asyncio.Event(), asyncio.Event()]
        st.tasks += [loop.create_task(run_server(regs[d], d + 1, ports[d],
                                                 peer_port=ports[1 - d], ready_event=ready[d],
                                                 server=st.servers[d])) for d in (0, 1)]
        await asyncio.gather(*(r.wait() for r in ready))
        for d in (0, 1):
            reader, writer = await asyncio.open_connection("127.0.0.1", ports[d])
            st.writers.append(writer)
            st.tasks.append(loop.create_task(_read(st, d, reader)))

    st.run(start(), 120)
    # the first frame calibrates each drone's int8 trunk; the rest warm up at the cell's rate
    for _ in range(s["warmup_frames"]):
        unit(ctx, st)
    ctx.phase("warmup")
    return st


def unit(ctx, st: State) -> None:
    """One frame at its due time on the cell's period; waits for both results."""
    period = 1.0 / ctx.sizes["rate"]
    now = time.perf_counter()
    st.due_next = max(st.due_next, now)
    f = st.next_frame
    st.next_frame += 1

    async def one():
        delay = st.due_next - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        await _send(st, f)
        return await _both(st, f, 600.0)

    if not st.run(one()):
        raise RuntimeError(f"frame {f} got no result from both drones")
    st.due_next += period


def latencies(due: Dict[int, float], arrived: Dict) -> List[float]:
    """Per frame due, seconds from its due time to the later of its two
    results; ``inf`` for a frame that either drone did not answer."""
    out = []
    for f, t in due.items():
        a, b = arrived.get((0, f)), arrived.get((1, f))
        out.append(math.inf if a is None or b is None else max(a[0], b[0]) - t)
    return out


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank over all values (inf counts)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def window(ctx, st: State, seconds: float) -> Window:
    rate = ctx.sizes["rate"]
    n = max(1, int(round(seconds * rate)))
    first = st.next_frame
    st.next_frame += n
    late = []

    async def drive():
        t0 = time.perf_counter() + 0.05
        due = {first + k: t0 + k / rate for k in range(n)}
        for f, t in due.items():
            delay = t - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            late.append(time.perf_counter() - t)
            await _send(st, f)
        close = t0 + n / rate
        # each drone serves its frames in order and drops, never reorders, a
        # backlog: once both have answered the last frame due, no earlier
        # frame can still come
        await _both(st, first + n - 1, max(0.0, close + WAIT_AFTER_CLOSE - time.perf_counter()))
        return due, close

    due, close = st.run(drive())
    lat = latencies(due, st.arrived)
    failed = sum(1 for x in lat if x == math.inf)
    half = n // 2
    st.window = {"frames": list(due), "late_max_s": max(late), "failed": failed,
                 "median_first_half_ms": 1e3 * float(np.median(lat[:half])) if half else None,
                 "median_second_half_ms": 1e3 * float(np.median(lat[half:])),
                 "p50_ms": 1e3 * float(np.median(lat))}
    st.due_next = time.perf_counter()
    return Window({"frame_latency_p95_ms": 1e3 * p95(lat)}, attempted=n, failed=failed,
                  seconds=close - min(due.values()), units=n)


def shutdown(st: State) -> None:
    """Stop the servers by their own bounded-run exit (``max_frames``): each
    serves one last frame, closes its connections and returns; then the
    clients' readers end, and the loop and its executor stop."""
    f = st.next_frame
    st.next_frame += 1

    async def stop():
        for s in st.servers:
            s.max_frames = s.frames_served + 1
        await _send(st, f)
        await asyncio.wait_for(asyncio.gather(*st.tasks, return_exceptions=True), 120)
        for w in st.writers:
            w.close()
        await st.loop.shutdown_default_executor()

    try:
        st.run(stop(), 180)
    finally:
        st.loop.call_soon_threadsafe(st.loop.stop)
        st.thread.join(60)


def evidence(ctx, st: State) -> dict:
    """Every frame of the window that both drones served, with its results
    and its index among the pool frames it was sent from (whose inputs the
    reference reads), and each drone's calibration crop (frame 0); then the
    servers stop."""
    frames = [f for f in (st.window or {}).get("frames", [])
              if (0, f) in st.arrived and (1, f) in st.arrived]
    uniq, inverse = np.unique(np.array([_frame_pool_index(st, f) for f in frames], np.int64),
                              return_inverse=True)
    ev = {"calib": st.pool.crops[0], "crops": st.pool.crops[uniq], "bb": st.pool.bb[uniq],
          "trans": st.pool.trans[uniq], "pool_index": inverse.reshape(-1),
          "served": np.stack([[st.arrived[(d, f)][1] for d in (0, 1)] for f in frames])
          if frames else np.zeros((0, 2, 145), np.float32),
          "unanswered": (st.window or {}).get("failed", 0)}
    shutdown(st)
    return ev


def normalize(crops_u8: np.ndarray, device) -> torch.Tensor:
    x = torch.as_tensor(crops_u8, device=device).float() / 255.0
    return (x - torch.tensor(IMG_MEAN, device=device)) / torch.tensor(IMG_STD, device=device)


@torch.no_grad()
def check(ctx, ev: dict) -> List[Check]:
    """Each drone's int8 trunk (its own calibration on its first crop), the
    two-view IEF from the mean parameters with the same frame's peer state,
    as the 145 wire floats of each pool frame; compared with what the
    servers sent for every frame served from it."""
    ref.no_tf32()
    s, dev, cfg = ctx.sizes, ctx.device, ctx.cfg
    sd = make_state(cfg, ctx.seed_of(1), dev)
    mean = np.load(MEAN_PARAMS)
    init = (torch.as_tensor(mean["pose"][:132], dtype=torch.float32, device=dev),
            torch.as_tensor(mean["shape"], dtype=torch.float32, device=dev))
    levels = {"int8": 127, "int4": 7}

    def served_by(level):
        feats = []
        for d in (0, 1):
            trunk = ref_int8.Int8Trunk(sd, cfg["trunk"], levels[level])
            scales = trunk.calibrate(normalize(ev["calib"][d][None], dev))
            feats.append(trunk(normalize(ev["crops"][:, d], dev), scales))
        xf = torch.stack(feats, dim=1)
        bb = torch.as_tensor(ev["bb"], device=dev)
        pos = torch.as_tensor(ev["trans"], device=dev) * ref.TRANS_SCALE
        pose, betas = ref.twoview_ief(sd, cfg, xf, bb, pos, init=init)
        out = torch.cat([betas, pose], dim=-1).cpu().numpy()   # (U, 2, 145) wire order
        return out[ev["pool_index"]]                            # (F, 2, 145)

    lim = ctx.cell.workload["limits"]
    if len(ev["served"]) == 0:
        return [Check(k, math.nan, v) for k, v in lim.items()]
    want = served_by(s["trunk"])
    got = served_by(ctx.control) if ctx.control else ev["served"]
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return [Check("betas_max", float(d[..., :10].max()), lim.get("betas_max")),
            Check("trans_max", float(d[..., 10:13].max()), lim.get("trans_max"),
                  {"unanswered": ev["unanswered"], "frames_compared": len(got),
                   "pool_frames": len(ev["crops"])}),
            Check("pose6d_max", float(d[..., 13:].max()), lim.get("pose6d_max"))]
