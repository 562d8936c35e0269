"""Per-drone inference server with the 3-round synchronization protocol
(port of airpose_tpu/serve/server.py, the same asyncio semantics and wire).

Replaces the reference's airpose_server/server.py + ROS step topics
(behavior from README): each drone runs one server; a client (the C++
airpose_client under native/, or any speaker of serve/protocol.py) streams
cropped images in; the two servers exchange step1/step2 messages directly
over TCP and return the 145-float step3 result to their client. The
reference demo runs the same topology on localhost at 4 FPS.

Usage:
  python -m airpose_tpu_torch.serve.server --port 9901 --peer-port 9902 \
      --robot-id 1 [--ckpt last.ckpt | --torch-ckpt ref.ckpt | --random-init]

Three differences from the JAX server's command line:
  * ``--platform {cpu,cuda}``: the card is the default, and without CUDA
    the server raises (``resolve_device``); ``cpu`` runs the plain versions.
  * ``--ckpt`` is a trainer ``.ckpt`` file of this package (the trainer's
    ``checkpoints/last.ckpt``); a directory (an orbax checkpoint of the JAX
    package) is refused.
  * ``--torch-ckpt`` loads a reference Lightning ``.ckpt`` with
    ``strict=True`` (train/checkpoint.load_model_variables).

The peer link is symmetric: the lower robot-id dials, the higher listens
(both servers accept either clients or the peer on their main port; the
first message on a connection tags its role).
"""

import argparse
import asyncio
import os
import struct
import time
from typing import Optional

import numpy as np

from .. import resolve_device
from ..utils.profiling import span
from . import protocol as P
from .staged import StagedRegressor, state_to_wire, wire_to_peer


class AirPoseServer:
    """Per-drone server with real-time semantics:

      * latest-frame-wins — a backlog of client frames is dropped down to
        the newest before processing (the reference's 4-FPS flight loop
        drops frames to stay real-time rather than queueing; README sync
        description, SURVEY.md §3.5/§7);
      * peer-timeout recovery — a missing peer message falls back to that
        peer's most recent earlier message (lag-one regime, exactly the
        in-flight semantics where the peer tensor is one round stale) or,
        before any peer contact, to the mean-parameter state step1 already
        assumes. A slow/disconnected peer degrades accuracy, never stalls
        the pipeline;
      * a peer that has passed a frame is not waited for: the peer serves
        its camera's frames in order over one ordered link, so once a
        message of a later frame arrives none will come for an earlier one
        (the peer dropped it from its backlog). A frame dropped at one drone
        so costs the other one degraded frame, not two peer timeouts during
        which both drop every frame that arrives.
    """

    def __init__(self, regressor: StagedRegressor, robot_id: int,
                 peer_timeout: float = 10.0,
                 max_frames: Optional[int] = None,
                 log_every: int = 0):
        self.reg = regressor
        self.robot_id = robot_id
        self.peer_timeout = peer_timeout
        self.peer_writer: Optional[asyncio.StreamWriter] = None
        self._peer_msgs: dict = {}
        self._events: dict = {}
        self._latest_peer: dict = {}   # msg_type -> freshest data seen
        self._peer_frame = -1          # frame of the peer's newest message on this link
        self._lock = asyncio.Lock()
        self.frames_dropped = 0
        self.peer_timeouts = 0
        # bounded runs: after max_frames step3 results the server resolves
        # `done` and run_server returns (demo/test runs exit cleanly
        # instead of serving forever)
        self.frames_served = 0
        self.max_frames = max_frames
        self.done = asyncio.Event()
        # live connection transports: closed when `done` resolves so
        # Server.wait_closed() (3.12.1+ waits on every accepted handler)
        # can't hang on a peer/client still parked in read_message
        self._transports: set = set()
        self._img_shape = None  # pinned to the first served frame
        # operational visibility (the reference's ROS nodes log status
        # continuously): every N served frames print the real-time health
        # counters — served/dropped/degraded tell a flight operator
        # whether the pipeline is keeping up and the peer link is alive,
        # the share of rounds replayed as CUDA graphs whether it runs warm
        self.log_every = log_every
        self._t0 = None

    def _maybe_log_stats(self):
        if not self.log_every or self.frames_served % self.log_every:
            return
        now = time.monotonic()
        rate = ("" if self._t0 is None else
                f" rate={self.log_every / max(now - self._t0, 1e-9):.2f} fps")
        self._t0 = now
        calls = self.reg.graph_replays + self.reg.eager_calls
        print(f"[robot {self.robot_id}] served={self.frames_served} "
              f"dropped={self.frames_dropped} "
              f"peer_timeouts={self.peer_timeouts} "
              f"graph_replays={self.reg.graph_replays / max(calls, 1):.1%}{rate}",
              flush=True)

    # ---- peer message bookkeeping ----

    # entries older than this many frames behind the peer's newest message
    # are unreachable (the processor only ever waits on its CURRENT frame)
    PEER_PRUNE_HORIZON = 8

    def _note_peer(self, msg_type: int, frame_id: int, data: np.ndarray):
        # frame-id regression = the peer's CLIENT restarted its counter
        # mid-link: entries from the old run (e.g. id 5000) would otherwise
        # survive every horizon prune and later be consumed as the NEW
        # run's frame 5000 — hours-stale state silently conditioning
        # rounds 2/3. Drop everything ahead of the restarted counter.
        newest = max((k[1] for k in self._peer_msgs if k[0] == msg_type),
                     default=frame_id)
        if frame_id + self.PEER_PRUNE_HORIZON < newest:
            for k in [k for k in self._peer_msgs
                      if k[0] == msg_type and k[1] > frame_id]:
                self._peer_msgs.pop(k, None)
                self._events.pop(k, None)
        self._peer_msgs[(msg_type, frame_id)] = data
        self._latest_peer[msg_type] = data
        self._events.setdefault((msg_type, frame_id), asyncio.Event()).set()
        # the peer has passed every earlier frame: wake their waits now
        self._peer_frame = frame_id
        for (_, f), ev in self._events.items():
            if f < frame_id:
                ev.set()
        # prune messages for frames this server dropped (latest-frame-wins)
        # or whose wait already timed out — only a successful _wait_peer
        # pops, so without this both dicts grow forever in exactly the
        # degraded real-time regime the drop policy serves
        horizon = frame_id - self.PEER_PRUNE_HORIZON
        stale = [k for k in self._peer_msgs
                 if k[0] == msg_type and k[1] < horizon]
        for k in stale:
            self._peer_msgs.pop(k, None)
            self._events.pop(k, None)

    async def _wait_peer(self, msg_type: int, frame_id: int):
        """Wait for the peer's message for this frame; on timeout, or once the
        peer has passed the frame, fall back to the freshest message of the
        same type (lag-one), else to the mean-parameter peer state (None →
        caller uses means)."""
        key = (msg_type, frame_id)
        if key not in self._peer_msgs and frame_id >= self._peer_frame:
            ev = self._events.setdefault(key, asyncio.Event())
            try:
                await asyncio.wait_for(ev.wait(), self.peer_timeout)
            except asyncio.TimeoutError:
                self.peer_timeouts += 1
                self._events.pop(key, None)
                return self._latest_peer.get(msg_type)
        self._events.pop(key, None)
        # the entry can vanish between the event firing and this task
        # resuming: a buffered message burst drains synchronously in
        # peer_loop and a newer frame's _note_peer may prune this key —
        # fall back to the freshest message (lag-one), never KeyError
        data = self._peer_msgs.pop(key, None)
        return data if data is not None else self._latest_peer.get(msg_type)

    def _peer_art_shape(self, data: Optional[np.ndarray]):
        if data is None:  # never heard from the peer: mean-parameter state
            return self.reg._mean_art[0], self.reg._mean_shape[0]
        return wire_to_peer(data)

    async def _send_peer(self, msg_type: int, frame_id: int, data: np.ndarray):
        # The peer link may come up after the first client frame arrives
        # (the higher-id server learns it from the dialer's HELLO). If the
        # peer never appears, keep serving degraded (mean/lag-one peer).
        for _ in range(int(self.peer_timeout * 10)):
            if self.peer_writer is not None:
                break
            await asyncio.sleep(0.1)
        writer = self.peer_writer
        if writer is None:
            return
        try:
            writer.write(P.encode_step(msg_type, frame_id, data))
            await writer.drain()
        except (ConnectionError, RuntimeError):
            # peer dropped mid-write: forget the link and keep serving
            # degraded — but only if it is still the CURRENT link. drain()
            # suspends, and a reconnecting peer may have installed a fresh
            # writer meanwhile; clearing unconditionally would discard the
            # live new link (same guard as peer_loop's finally).
            if self.peer_writer is writer:
                self.peer_writer = None

    # ---- connection handlers ----

    async def peer_loop(self, reader, writer, first=None):
        self.peer_writer = writer
        self._transports.add(writer)
        # Fresh peer link ⇒ fresh peer run: its frame counter may restart
        # at 0, so buffered state from the previous link (messages AND the
        # lag-one fallback) would be consumed as the wrong frames' state.
        self._peer_msgs.clear()
        self._latest_peer.clear()
        self._peer_frame = -1
        for ev in self._events.values():
            ev.set()  # wake waiters parked on old-link keys (they fall
        self._events.clear()  # back lag-one/mean, never a stale message)
        try:
            msg = first
            while True:
                if msg is not None:
                    msg_type, payload = msg
                    if msg_type in (P.MSG_STEP1, P.MSG_STEP2):
                        self._note_peer(msg_type, *P.decode_step(payload))
                msg = await P.read_message(reader)
                if msg is None:
                    break
        except P.ProtocolError as e:
            # A corrupt peer stream cannot be resynced — drop the link and
            # keep serving degraded (lag-one/mean peer), never crash
            print(f"[robot {self.robot_id}] peer link protocol error: {e}; "
                  "closing peer connection", flush=True)
        finally:
            # Close the transport when the handler exits — INCLUDING on
            # cancellation. Server.wait_closed() (3.12+) waits for every
            # accepted connection to detach; a cancelled handler that
            # leaves its writer open keeps the peer link's connection
            # alive forever and run_server hangs mid-cancel (the
            # "Task was destroyed but it is pending" unraisable).
            if self.peer_writer is writer:
                # back to no-peer mode: frames keep flowing with the
                # mean/lag-one fallback, and a reconnecting peer can
                # re-establish the link
                self.peer_writer = None
            self._transports.discard(writer)
            try:
                writer.close()
            except RuntimeError:
                pass  # loop already closed (GC-time teardown)

    async def client_loop(self, reader, writer, first=None):
        """Pump incoming messages into a queue and process the NEWEST
        pending frame, dropping the backlog (latest-frame-wins)."""
        q: asyncio.Queue = asyncio.Queue()
        self._transports.add(writer)
        if first is not None:
            q.put_nowait(first)

        async def pump():
            while True:
                try:
                    msg = await P.read_message(reader)
                except P.ProtocolError as e:
                    # corrupt framing: the stream has no resync marker, so
                    # report and treat as EOF — the consumer below MUST
                    # still get its sentinel or it waits on the queue
                    # forever with the connection leaked
                    print(f"[robot {self.robot_id}] client protocol error: "
                          f"{e}; closing connection", flush=True)
                    msg = None
                q.put_nowait(msg)  # None marks EOF
                if msg is None:
                    return

        pump_task = asyncio.ensure_future(pump())
        try:
            eof = False
            while not eof:
                msg = await q.get()
                if msg is None:
                    break
                # drain the backlog: keep only the newest frame
                while not q.empty():
                    nxt = q.get_nowait()
                    if nxt is None:
                        eof = True
                        break
                    if msg[0] == P.MSG_IMAGE:
                        self.frames_dropped += 1
                    msg = nxt
                if msg is not None and msg[0] == P.MSG_IMAGE:
                    try:
                        await self._process_frame(writer, msg[1])
                    except P.ProtocolError as e:
                        print(f"[robot {self.robot_id}] bad IMAGE payload: "
                              f"{e}; closing connection", flush=True)
                        break
        finally:
            pump_task.cancel()
            self._transports.discard(writer)
            try:  # see peer_loop: detach from Server.wait_closed()
                writer.close()
            except RuntimeError:
                pass  # loop already closed (GC-time teardown)

    async def _device_call(self, fn, *args):
        """``fn(*args)``, one round's device call, on the default executor.

        Device calls run in the executor, NOT on the event loop: each call
        blocks until its device→host copy, and meanwhile peer step messages
        must keep draining (a blocked loop delays _note_peer and turns the
        peer's wait into false lag-one degradation), and two co-hosted
        servers (benchtest, localhost demos) can overlap their calls instead
        of serializing the whole 6-call protocol. self._lock still
        serializes calls per server (the first call's kernel build and the
        int8 first-frame calibration mutate shared state)."""
        async with self._lock:
            with span("serve_executor"):
                return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def _process_frame(self, writer, payload: bytes):
        """The 3-round protocol for one frame (SURVEY.md §3.5).

        Under a profiler that records this thread, the frame is a
        ``serve_frame`` span from the decoded payload to the drained result;
        inside it each round's executor call is a ``serve_executor`` span
        (submitted → result back on the loop; the executor thread's
        ``staged_step`` lies inside it) and each peer wait a
        ``serve_peer_wait`` span, timeouts included. Two servers in one
        process share the loop thread, so their spans overlap there."""
        _, frame_id, bb, init_trans, img = P.decode_image(payload)
        with span("serve_frame"):
            # Pin the crop shape to the first served frame: a client
            # streaming varying legal dims would make every frame allocate
            # and tune for a new shape while holding self._lock, stalling
            # BOTH drones' serving. A legitimate deployment uses one fixed
            # crop size per flight.
            if self._img_shape is None:
                self._img_shape = img.shape
            elif img.shape != self._img_shape:
                raise P.ProtocolError(
                    f"IMAGE shape {img.shape} differs from this server's "
                    f"pinned shape {self._img_shape}")

            # Round 1: trunk + IEF iter 1 (mean peer), publish step1. The raw
            # uint8 crop goes straight to the device and is normalized there
            # (4× smaller upload; staged.py).
            state = await self._device_call(self.reg.step1, img[None], bb[None],
                                            init_trans[None])
            await self._send_peer(P.MSG_STEP1, frame_id, state_to_wire(state))

            # Round 2: peer step1 → iter 2, publish step2.
            with span("serve_peer_wait"):
                data = await self._wait_peer(P.MSG_STEP1, frame_id)
            art, shape = self._peer_art_shape(data)
            state = await self._device_call(self.reg.step23, state, bb[None], art[None],
                                            shape[None])
            await self._send_peer(P.MSG_STEP2, frame_id, state_to_wire(state))

            # Round 3: peer step2 → iter 3, return the 145-float result.
            with span("serve_peer_wait"):
                data = await self._wait_peer(P.MSG_STEP2, frame_id)
            art, shape = self._peer_art_shape(data)
            state = await self._device_call(self.reg.step23, state, bb[None], art[None],
                                            shape[None])
            writer.write(P.encode_step(P.MSG_RESULT, frame_id, state_to_wire(state)))
            await writer.drain()
        self.frames_served += 1
        self._maybe_log_stats()
        if self.max_frames is not None and self.frames_served >= self.max_frames:
            # drain() only means below-high-water: flush the final result
            # all the way out before the loop shuts down, or the client
            # sees EOF instead of its step3 message
            writer.close()
            await writer.wait_closed()
            self.done.set()


async def run_server(
    regressor: StagedRegressor,
    robot_id: int,
    port: int,
    peer_host: str = "127.0.0.1",
    peer_port: int = 0,
    ready_event: Optional[asyncio.Event] = None,
    peer_timeout: float = 10.0,
    server: Optional[AirPoseServer] = None,
    max_frames: Optional[int] = None,
    log_every: int = 0,
):
    if server is None:
        server = AirPoseServer(regressor, robot_id, peer_timeout=peer_timeout,
                               max_frames=max_frames, log_every=log_every)

    async def on_connect(reader, writer):
        try:
            msg = await P.read_message(reader)
        except P.ProtocolError as e:
            print(f"[robot {robot_id}] rejected connection: {e}", flush=True)
            writer.close()
            return
        if msg is None:
            writer.close()
            return
        if msg[0] == P.MSG_IMAGE:
            await server.client_loop(reader, writer, first=msg)
        elif msg[0] == P.MSG_HELLO:
            # ONLY a HELLO opens the peer link (the dialer always sends
            # one, see below). Routing any non-IMAGE first message here
            # would let a stray/hostile connection displace a live peer
            # link and silently degrade both drones to lag-one serving.
            await server.peer_loop(reader, writer, first=msg)
        else:
            print(f"[robot {robot_id}] rejected connection: first message "
                  f"type {msg[0]} is neither IMAGE nor HELLO", flush=True)
            writer.close()

    tcp = await asyncio.start_server(on_connect, "127.0.0.1", port)

    # lower id dials the peer; the window covers a peer process that is
    # still importing/compiling at its own startup (separate-process
    # topology, benchtest --rate-procs)
    if peer_port and robot_id <= 1:
        for _ in range(600):
            try:
                reader, writer = await asyncio.open_connection(peer_host, peer_port)
                server.peer_writer = writer
                writer.write(P.frame(P.MSG_HELLO, struct.pack("<I", robot_id)))
                await writer.drain()
                asyncio.ensure_future(server.peer_loop(reader, writer))
                break
            except OSError:
                await asyncio.sleep(0.1)

    if ready_event is not None:
        ready_event.set()
    async with tcp:
        if server.max_frames is not None:
            await server.done.wait()
            # Detach every live connection: Server.wait_closed()
            # (3.12.1+ semantics) blocks until all accepted handlers
            # finish, and the peer link would otherwise sit in
            # read_message forever — --max-frames must exit, not hang.
            for w in list(server._transports):
                try:
                    w.close()
                except RuntimeError:
                    pass
        else:
            await tcp.serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--peer-host", default="127.0.0.1")
    parser.add_argument("--peer-port", type=int, default=0)
    parser.add_argument("--robot-id", type=int, required=True,
                        help="1 or 2; with --model copenet_twoview_sep this "
                             "selects which drone's weight copy serves")
    parser.add_argument("--model", default="copenet_twoview",
                        choices=("copenet_twoview", "copenet_twoview_sep"))
    parser.add_argument("--ckpt", default=None,
                        help="this package's trainer checkpoint, a .ckpt file "
                             "(<run>/checkpoints/last.ckpt); a directory (orbax) "
                             "is refused")
    parser.add_argument("--torch-ckpt", default=None,
                        help="reference Lightning .ckpt, loaded strict (the "
                             "reference's `python server.py -p PORT -m "
                             "file.ckpt` deployment contract)")
    parser.add_argument("--random-init", action="store_true",
                        help="serve random weights of seed 0 (protocol testing)")
    parser.add_argument("--int8", action="store_true",
                        help="serve with the int8 PTQ trunk (activation scales "
                             "calibrate on the first frame batch — "
                             "ops/int8_trunk.py)")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="serve this many frames, then exit cleanly "
                             "(bounded demo/test runs; default: forever)")
    parser.add_argument("--log-every", type=int, default=0,
                        help="print served/dropped/peer-timeout counters, "
                             "the share of rounds replayed as CUDA graphs and "
                             "the recent serve rate every N frames "
                             "(operational health; default: off)")
    parser.add_argument("--peer-timeout", type=float, default=10.0,
                        help="seconds to wait for a peer step message before "
                             "degrading to its last known state (flight "
                             "deployments set ~0.25 at 4 FPS)")
    parser.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                        help="the device (default: the CUDA device; raises "
                             "without one)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.platform)

    if args.robot_id not in (1, 2):
        parser.error("--robot-id must be 1 or 2")
    model = load_served_model(parser, args, dev)
    # a _sep checkpoint carries per-drone weight copies; this process IS one
    # drone, so it serves its own copy (ref model_copenet_sep.py:169-237)
    sep_view = (args.robot_id - 1) if args.model == "copenet_twoview_sep" \
        else None
    reg = StagedRegressor(model, sep_view=sep_view, int8=args.int8, device=dev)
    asyncio.run(
        run_server(reg, args.robot_id, args.port, args.peer_host,
                   args.peer_port, peer_timeout=args.peer_timeout,
                   max_frames=args.max_frames, log_every=args.log_every)
    )


def load_served_model(parser: argparse.ArgumentParser, args, device):
    """The f32 model of ``args.model`` on ``device`` from exactly one of
    ``--ckpt`` (a .ckpt file), ``--torch-ckpt`` or ``--random-init``; the
    serving CLIs' shared weight loading."""
    from ..train.checkpoint import load_model_variables

    if (args.ckpt is not None) + (args.torch_ckpt is not None) + args.random_init != 1:
        parser.error("provide exactly one of --ckpt, --torch-ckpt or --random-init")
    if args.ckpt is not None and os.path.isdir(args.ckpt):
        parser.error(f"{args.ckpt} is a directory: the port reads no orbax checkpoint; "
                     "pass a .ckpt file (airpose_tpu.train.checkpoint."
                     "export_reference_checkpoint writes one from a JAX run)")
    try:
        model, _ = load_model_variables(args.model, torch_ckpt=args.torch_ckpt or args.ckpt,
                                        random_init=args.random_init, device=device)
    except ValueError as e:
        parser.error(str(e))
    return model


if __name__ == "__main__":
    main()
