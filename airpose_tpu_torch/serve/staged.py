"""Staged single-view inference for the 3-step protocol (port of
airpose_tpu/serve/staged.py).

The fused two-view forward's IEF loop (models/airpose.py) factors into
three per-drone steps whose cross-view inputs arrive over the network:

  step1: trunk features + IEF iter 1, peer state = mean params
  step2: IEF iter 2 with the peer's step-1 state
  step3: IEF iter 3 with the peer's step-2 state  → final result

With both peers' messages from the same frame, step1..3 reproduce the
fused 3-iter forward. In flight the peer message lags a round; the staged
path is then deliberately *not* identical on moving subjects
(serve/lagone.py measures by how much).

Each round is its uploads, the device work and one device→host copy of the
new pose and shape; the trunk features stay on the device between rounds.
On a card each round's device work is a CUDA graph (``_Round``): the first
call of an input shape runs eagerly (the int8 trunk calibrates there), the
second captures the round and replays it, and later calls replay it, so a
round is a handful of host calls instead of one or more per kernel. Its
inputs pass through pinned host buffers into the graph's static inputs and
the new pose and shape come back through a pinned buffer. On the CPU every
call runs eagerly.

The server calls ``step1``/``step23`` from executor threads, where grad
mode is not the caller's (it is thread-local), so each method enters
``torch.inference_mode`` itself. Each call is one ``staged_step`` profiler
span (``utils.profiling.span``), the upload to the copy back.
"""

import contextlib
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device
from ..models.airpose import _regress_step, mean_init_state
from ..utils.profiling import span
from .protocol import pack_params, unpack_params

# One capture at a time in the process: the caching allocator and cuBLAS's
# workspaces are shared by every regressor, and two drones reach their
# second frame together.
_capture_lock = threading.Lock()


def normalize_host(img_u8: np.ndarray) -> np.ndarray:
    """Host-side uint8→normalized-float crop (the serving path normalizes
    on the device, ``StagedRegressor._normalize``; one shared definition so
    the host-side consumers, benchtest replay and tests, cannot drift)."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(C.IMG_NORM_MEAN)) / np.asarray(C.IMG_NORM_STD)


class ViewState(NamedTuple):
    pose: np.ndarray     # (B, 135) [trans*scale | 6D×22] — host (wire access)
    shape: np.ndarray    # (B, 10) — host (wire access)
    xf: torch.Tensor     # (B, 2048) trunk features — on the device between steps


def state_to_wire(state: ViewState, i: int = 0) -> np.ndarray:
    """ViewState row → 145-float message (β, scaled trans, 6D pose)."""
    return pack_params(
        np.asarray(state.shape[i]),
        np.asarray(state.pose[i, :3]) / C.TRANS_SCALE,
        np.asarray(state.pose[i, 3:]),
    )


def wire_to_peer(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """145-float peer message → (art_pose (126,), shape (10,)) — the two
    tensors the regressor conditions on from the other view."""
    betas, _, pose6d = unpack_params(data)
    return pose6d[6:], betas


class _Round:
    """One round's device work captured as a CUDA graph on the current
    (side) stream, and its replays.

    ``fn(*inputs)`` returns the (B, 145) new pose and shape, then any
    further device outputs. The host inputs are copied into pinned buffers
    and from there into the graph's static device inputs, the device inputs
    into theirs; the pose and shape come back through a pinned buffer. A
    replay overwrites the static outputs, so ``run`` hands back copies."""

    def __init__(self, fn, host_args, dev_args, device):
        self.host_in = [torch.tensor(a).pin_memory() for a in host_args]
        self.host_views = [h.numpy() for h in self.host_in]
        self.dev_in = [h.to(device) for h in self.host_in] + [t.clone() for t in dev_args]
        self.graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.wire, *self.dev_out = fn(*self.dev_in)
            finally:
                self.graph.capture_end()
        self.host_out = torch.empty(self.wire.shape, dtype=self.wire.dtype, pin_memory=True)

    def run(self, host_args, dev_args):
        """Load the inputs, replay, copy back: (pose|shape (B, 145) on the
        host, copies of the further device outputs)."""
        for view, a in zip(self.host_views, host_args):
            np.copyto(view, a)
        for d, src in zip(self.dev_in, self.host_in + list(dev_args)):
            d.copy_(src, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.wire, non_blocking=True)
        dev_out = [t.clone() for t in self.dev_out]
        torch.cuda.current_stream().synchronize()
        return self.host_out.numpy().copy(), dev_out


class StagedRegressor:
    """step1/2/3 over an ``AirPoseTwoView`` (or, with ``sep_view`` set, one
    drone's half of an ``AirPoseTwoViewSep``: its trunk and core
    ``sep_view``, as ``AirPoseTwoViewSepView(view=sep_view)`` runs them) on
    ``device`` (CUDA by default; raises without it). The model serves in
    f32 as the JAX package's does.

    ``int8=True`` serves the int8 PTQ trunk (ops/int8_trunk.py): the trunk
    is quantized up front and its activation scales calibrate on the FIRST
    frame batch, since serving calibrates on deployment data by design.

    On a card the regressor runs on a stream of its own and keeps two kinds
    of rounds as CUDA graphs, keyed by what it observes: step 1 by the
    crops' shape and dtype, steps 2-3 by the batch. The graphs hold the
    weights and the calibrated scales as they were at capture.
    ``eager_calls`` and ``graph_replays`` count the calls that ran eagerly
    and those served by a replay (the capturing call among them).

    One call at a time per regressor: the rounds share their static
    buffers, and the server keeps this through ``AirPoseServer._lock``.
    Regressors on other threads may run and capture meanwhile."""

    def __init__(self, model, sep_view: int = None, int8: bool = False, device=None):
        self.device = resolve_device(device)
        model = model.to(self.device)
        if sep_view is None:
            self._trunk, self._core = model.trunk, model.core
        elif sep_view in (0, 1):
            self._trunk = getattr(model, f"trunk{sep_view}")
            self._core = getattr(model, f"core{sep_view}")
        else:
            raise ValueError(f"sep_view must be 0 or 1, got {sep_view}")
        mean_pose, mean_shape, _ = mean_init_state((1,), "cpu")
        self._mean_art = mean_pose[:, 6:].numpy()
        self._mean_shape = mean_shape.numpy()
        self._mean_pose_d = mean_pose.to(self.device)
        self._mean_shape_d = mean_shape.to(self.device)
        self._norm_mean = torch.tensor(C.IMG_NORM_MEAN, device=self.device)
        self._norm_std = torch.tensor(C.IMG_NORM_STD, device=self.device)

        self.int8 = int8
        self._act_scales = None
        if int8:
            from ..ops import quantize_trunk_params

            self._qp = quantize_trunk_params(self._trunk.state_dict())

        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._rounds = {}  # key → None (seen once, eager) or its _Round
        self.eager_calls = 0
        self.graph_replays = 0

    def _normalize(self, image: torch.Tensor) -> torch.Tensor:
        """uint8 crops → normalized f32 on the device; float crops are taken
        as already normalized."""
        if image.dtype == torch.uint8:
            image = image.float() / 255.0
            return (image - self._norm_mean) / self._norm_std
        return image.float()

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if not self.int8:
            return self._trunk(x)
        from ..ops import (calibrate_act_scales, calibration_clip_rates,
                           resnet50_int8_infer)

        if self._act_scales is None:
            self._act_scales = calibrate_act_scales(self._qp, x)
            rates = calibration_clip_rates(self._qp, self._act_scales, x)
            print(f"int8 serving calibrated on {int(x.shape[0])} "
                  f"frame(s); clip rate max "
                  f"{max(rates.values()):.2e} — exposure/contrast "
                  "swings beyond this sample will clip (see "
                  "ops/int8_trunk.calibration_clip_rates)", flush=True)
        return resnet50_int8_infer(self._qp, x, act_scales=self._act_scales)

    def _round1(self, image: torch.Tensor, head: torch.Tensor):
        """Step 1's device work: (pose|shape (B, 145), trunk features)."""
        x = self._normalize(image)
        bb_d, trans_d = head.split(3, dim=-1)
        xf = self._features(x)
        B = xf.shape[0]
        pose = torch.cat([trans_d * C.TRANS_SCALE,
                          self._mean_pose_d.expand(B, -1)], dim=-1)
        shape = self._mean_shape_d.expand(B, -1)
        new_pose, new_shape = _regress_step(self._core, xf, bb_d, pose, shape,
                                            self._mean_pose_d[:, 6:].expand(B, -1), shape)
        return torch.cat([new_pose, new_shape], dim=-1), xf

    def _round23(self, head: torch.Tensor, xf: torch.Tensor):
        """Step 2's or 3's device work: (pose|shape (B, 145),)."""
        bb_d, pose, shape, art, pshape = head.split((3, 135, 10, 126, 10), dim=-1)
        new_pose, new_shape = _regress_step(self._core, xf, bb_d, pose, shape, art, pshape)
        return (torch.cat([new_pose, new_shape], dim=-1),)

    def _call(self, key, fn, host_args, dev_args=()):
        """``fn`` on ``host_args`` uploaded and ``dev_args``, on this
        regressor's stream: (pose (B, 135), shape (B, 10) on the host,
        fn's further outputs). On a card the first call of ``key`` runs
        eagerly, the second captures ``fn`` and every later one replays it."""
        with span("staged_step"), torch.inference_mode(), (
                contextlib.nullcontext() if self._stream is None
                else torch.cuda.stream(self._stream)):
            if self._stream is None or key not in self._rounds:
                self._rounds[key] = None
                self.eager_calls += 1
                wire, *rest = fn(*(torch.tensor(a, device=self.device) for a in host_args),
                                 *dev_args)
                both = wire.cpu().numpy()
            else:
                if self._rounds[key] is None:
                    self._rounds[key] = _Round(fn, host_args, dev_args, self.device)
                self.graph_replays += 1
                both, rest = self._rounds[key].run(host_args, dev_args)
        return both[:, :135], both[:, 135:], rest

    def step1(self, image: np.ndarray, bb: np.ndarray,
              init_trans: np.ndarray) -> ViewState:
        """image (B,S,S,3) — uint8 raw (preferred: 4× smaller upload,
        normalized on the device) or already-normalized float; bb (B,3);
        init_trans (B,3) unscaled. Runs trunk + IEF iter 1 against the
        mean peer state. The state owns its features: a later call leaves
        them as they are."""
        image = np.asarray(image)
        head = np.concatenate([np.asarray(bb, np.float32),
                               np.asarray(init_trans, np.float32)], axis=-1)
        pose, shape, (xf,) = self._call(("step1", image.shape, image.dtype), self._round1,
                                        (image, head))
        return ViewState(pose=pose, shape=shape, xf=xf)

    def step23(self, state: ViewState, bb: np.ndarray,
               peer_art: np.ndarray, peer_shape: np.ndarray) -> ViewState:
        """One further IEF iteration with an explicit peer state (used for
        both step2 and step3); the trunk features stay on the device."""
        B = state.xf.shape[0]
        head = np.concatenate([
            np.broadcast_to(np.asarray(bb, np.float32), (B, 3)),
            np.asarray(state.pose, np.float32), np.asarray(state.shape, np.float32),
            np.broadcast_to(np.asarray(peer_art, np.float32), (B, 126)),
            np.broadcast_to(np.asarray(peer_shape, np.float32), (B, 10))], axis=-1)
        pose, shape, _ = self._call(("step23", B), self._round23, (head,), (state.xf,))
        return ViewState(pose=pose, shape=shape, xf=state.xf)
