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

Each round is one upload, the device work and one device→host copy of the
new pose and shape; the trunk features stay on the device between rounds.
The server calls ``step1``/``step23`` from executor threads, where grad
mode is not the caller's (it is thread-local), so each method enters
``torch.inference_mode`` itself. Each call is one ``staged_step`` profiler
span (``utils.profiling.span``), the upload to the copy back.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import resolve_device
from ..models.airpose import _regress_step, mean_init_state
from ..utils.profiling import span
from .protocol import pack_params, unpack_params


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


class StagedRegressor:
    """step1/2/3 over an ``AirPoseTwoView`` (or, with ``sep_view`` set, one
    drone's half of an ``AirPoseTwoViewSep``: its trunk and core
    ``sep_view``, as ``AirPoseTwoViewSepView(view=sep_view)`` runs them) on
    ``device`` (CUDA by default; raises without it). The model serves in
    f32 as the JAX package's does.

    ``int8=True`` serves the int8 PTQ trunk (ops/int8_trunk.py): the trunk
    is quantized up front and its activation scales calibrate on the FIRST
    frame batch, since serving calibrates on deployment data by design."""

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

    def _to_host(self, pose: torch.Tensor, shape: torch.Tensor):
        """One device→host copy of the new (pose, shape)."""
        both = torch.cat([pose, shape], dim=-1).cpu().numpy()
        return both[:, :135], both[:, 135:]

    def step1(self, image: np.ndarray, bb: np.ndarray,
              init_trans: np.ndarray) -> ViewState:
        """image (B,S,S,3) — uint8 raw (preferred: 4× smaller upload,
        normalized on the device) or already-normalized float; bb (B,3);
        init_trans (B,3) unscaled. Runs trunk + IEF iter 1 against the
        mean peer state."""
        with span("staged_step"), torch.inference_mode():
            x = self._normalize(torch.tensor(np.asarray(image), device=self.device))
            host = np.concatenate([np.asarray(bb, np.float32),
                                   np.asarray(init_trans, np.float32)], axis=-1)
            bb_d, trans_d = torch.from_numpy(host).to(self.device).split(3, dim=-1)
            xf = self._features(x)
            B = xf.shape[0]
            pose = torch.cat([trans_d * C.TRANS_SCALE,
                              self._mean_pose_d.expand(B, -1)], dim=-1)
            shape = self._mean_shape_d.expand(B, -1)
            new_pose, new_shape = _regress_step(self._core, xf, bb_d, pose, shape,
                                                self._mean_pose_d[:, 6:].expand(B, -1), shape)
            pose_h, shape_h = self._to_host(new_pose, new_shape)
        return ViewState(pose=pose_h, shape=shape_h, xf=xf)

    def step23(self, state: ViewState, bb: np.ndarray,
               peer_art: np.ndarray, peer_shape: np.ndarray) -> ViewState:
        """One further IEF iteration with an explicit peer state (used for
        both step2 and step3); the trunk features stay on the device."""
        B = state.xf.shape[0]
        with span("staged_step"), torch.inference_mode():
            host = np.concatenate([
                np.broadcast_to(np.asarray(bb, np.float32), (B, 3)),
                np.asarray(state.pose, np.float32), np.asarray(state.shape, np.float32),
                np.broadcast_to(np.asarray(peer_art, np.float32), (B, 126)),
                np.broadcast_to(np.asarray(peer_shape, np.float32), (B, 10))], axis=-1)
            bb_d, pose, shape, art, pshape = torch.from_numpy(host).to(self.device).split(
                (3, 135, 10, 126, 10), dim=-1)
            new_pose, new_shape = _regress_step(self._core, state.xf, bb_d, pose, shape,
                                                art, pshape)
            pose_h, shape_h = self._to_host(new_pose, new_shape)
        return ViewState(pose=pose_h, shape=shape_h, xf=state.xf)
