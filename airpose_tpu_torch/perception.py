"""The two-view perception chain, the port's main path (the chain of the root
bench.py:109-125):

  1. both 224² crops of each frame through one ResNet-50 trunk (views folded
     into the batch), one of three:
     - ``"int8"`` (the root bench's default): the int8 PTQ trunk of
       ops/int8_trunk.py, every conv on the int8 conv kernel;
     - ``"int8_block"``: the bf16 stem and layer1, then layers 2-4 as 13
       int8 blocks (ops/int8_bottleneck.py);
     - ``"bf16"`` (``AIRPOSE_BENCH_BF16=1`` in the root bench): stem → fused
       layer1 kernel → layers 2-4;
  2. three IEF steps, each view reading the other's pose and shape;
  3. 6D → rotmat;
  4. SMPL-X forward (10,475 vertices, 127 joints), skinned by the kernel;
  5. cam_frame_and_project.

Each stage runs inside a profiler span (``utils.profiling.span``: trunk,
ief, smplx, project, and the trunk's own spans inside it), which the
benchmark's traced run reads; without an active profiler a span is one flag
check.

``perceive_hmr2`` runs HMR 2.0 (models/hmr2.py) on the same batches: both
drones' 256² crops folded into one batch and regressed one by one (the
model has no exchange between views), 6D → rotmat, SMPL (6,890 vertices, 45
joints) with the same skinning kernel, each crop's weak-perspective camera
to a camera-frame translation, the same projection; its spans are ``vit``
(``patch_embed``, ``vit_blocks`` inside), ``hmr2_head``, ``smpl`` and
``project``.

``perceive_multihmr`` runs Multi-HMR (models/multihmr.py) on whole 896²
frames of both drones: the DINOv2 backbone over every frame, detection's
score map, the head over every person (the centres given, or those
detection finds), whole-body SMPL-X (posed hands and jaw, expression) with
the same skinning kernel, each person's translation from its centre and
depth, the projection. Its spans are ``vit`` (``patch_embed``,
``vit_blocks`` and each block's ``attention`` inside), ``detect``, ``hph``,
``smplx`` and ``project``.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import constants as C
from . import resolve_device
from .bodymodel.smpl import SMPLParams, smpl_forward
from .bodymodel.smplx import SMPLXParams, smplx_forward, synthetic_smplx_params
from .geometry.projection import backproject
from .geometry.rotations import rot6d_to_rotmat
from .models.airpose import AirPoseTwoView
from .models.hmr2 import HMR2, pose_rotmats
from .models.multihmr import NUM_POSE_JOINTS, MultiHMR, Persons
from .ops.fused_bottleneck import resnet50_fused_infer, stage1_params_from_state_dict
from .ops.int8_bottleneck import quantize_trunk_blocks, resnet50_int8_block_infer
from .ops.int8_trunk import (calibrate_act_scales, quantize_trunk_params,
                             resnet50_int8_infer)
from .train.losses import cam_frame_and_project
from .utils.profiling import span

TRUNKS = ("bf16", "int8", "int8_block")

# A prepared trunk: features(crops (N, H, W, 3), use_kernels=True) → (N, 2048) f32.
Features = Callable[..., torch.Tensor]


@torch.no_grad()
def chain_ops(model: AirPoseTwoView, trunk: str = "bf16",
              calib_images: Optional[torch.Tensor] = None) -> Features:
    """Prepare ``trunk`` (one of TRUNKS) from ``model``'s weights once and
    return its features function, a ``functools.partial`` of the trunk's
    infer function whose ``args``/``keywords`` hold the operands. The int8
    trunks quantize the folded trunk and calibrate their activation scales
    on ``calib_images`` (N, H, W, 3), as the root bench.py:98-102 does."""
    if trunk == "bf16":
        return partial(resnet50_fused_infer, model.trunk,
                       stage_ops=stage1_params_from_state_dict(model.trunk.state_dict()))
    if trunk not in TRUNKS:
        raise ValueError(f"unknown trunk {trunk!r}, expected one of {TRUNKS}")
    qparams = quantize_trunk_params(model.trunk.state_dict())
    scales = calibrate_act_scales(qparams, calib_images)
    if trunk == "int8":
        return partial(resnet50_int8_infer, qparams, act_scales=scales)
    return partial(resnet50_int8_block_infer, model.trunk,
                   quantize_trunk_blocks(qparams, scales))


@torch.no_grad()
def perceive(
    model: AirPoseTwoView,
    smplx_params: SMPLXParams,
    images: torch.Tensor,         # (B, 2, H, W, 3)
    bb: torch.Tensor,             # (B, 2, 3)
    init_position: torch.Tensor,  # (B, 2, 3)
    intr: torch.Tensor,           # (B, 2, 3, 3)
    features: Optional[Features] = None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (vertices (B, 2, V, 3), j2d (B, 2, 127, 2)). Runs where its inputs
    are: kernels on the card, their plain versions on the CPU, or the plain
    versions on the card with ``use_kernels=False``. ``features`` is the
    trunk that ``chain_ops`` (or ``build_perception``) prepared; ``None``
    prepares the bf16 trunk at the call."""
    B = images.shape[0]
    features = features or chain_ops(model, "bf16")
    with span("trunk"):
        xf = features(images.reshape((B * 2,) + images.shape[2:]),
                      use_kernels=use_kernels).reshape(B, 2, -1)
    with span("ief"):
        out = model.from_features(xf, bb, init_position)
        trans = out.pose[..., :3] / C.TRANS_SCALE
        rotmat = rot6d_to_rotmat(out.pose[..., 3:].reshape(B, 2, 22, 6))
    with span("smplx"):
        eye = torch.eye(3, dtype=rotmat.dtype, device=rotmat.device).expand(B * 2, 1, 3, 3)
        body = smplx_forward(
            smplx_params,
            out.betas.reshape(B * 2, 10),
            body_pose=rotmat[:, :, 1:].reshape(B * 2, 21, 3, 3),
            global_orient=eye,
            use_kernels=use_kernels,
        )
    with span("project"):
        joints = body.joints.reshape(B, 2, -1, 3)
        verts = body.vertices.reshape(B, 2, -1, 3)
        _, j2d = cam_frame_and_project(rotmat[:, :, 0], trans, joints, intr,
                                       C.FOCAL_LENGTH)
    return verts, j2d


def cam_crop_to_full(cam: torch.Tensor, bb: torch.Tensor, intr: torch.Tensor,
                     crop: int) -> torch.Tensor:
    """HMR 2.0's ``cam_crop_to_full`` with a drone camera: a crop's weak-
    perspective camera (s, tx, ty) (..., 3) → the body's translation in the
    camera frame (..., 3). The crop box comes from ``bb`` = (box centre /
    principal point − 1, crop / box side) and the focal length and principal
    point from ``intr`` (..., 3, 3), where the published demo assumes a
    focal length of 5000 / 256 of the image's larger side about its
    centre."""
    f, pp = intr[..., 0, 0], intr[..., :2, 2]
    offset = bb[..., :2] * pp                   # box centre − principal point
    bs = crop / bb[..., 2] * cam[..., 0] + 1e-9
    return torch.stack([2 * offset[..., 0] / bs + cam[..., 1],
                        2 * offset[..., 1] / bs + cam[..., 2], 2 * f / bs], dim=-1)


@torch.no_grad()
def perceive_hmr2(
    model: HMR2,
    smpl_params: SMPLParams,
    images: torch.Tensor,         # (B, 2, S, S, 3)
    bb: torch.Tensor,             # (B, 2, 3)
    intr: torch.Tensor,           # (B, 2, 3, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HMR 2.0 over both drones' crops → (vertices (B, 2, V, 3), j2d
    (B, 2, 45, 2)). The vertices are SMPL's with the regressed root
    rotation, before the translation; the 45 joints are projected from the
    camera frame with ``intr``. Runs where its inputs are, as ``perceive``."""
    B = images.shape[0]
    x = images.reshape((B * 2,) + images.shape[2:])
    with span("vit"):
        tokens = model.backbone(model.crop_columns(x))
    with span("hmr2_head"):
        out = model.smpl_head(tokens)
        rotmat = pose_rotmats(out.pose6d)
    with span("smpl"):
        body = smpl_forward(smpl_params, out.betas, rotmat[:, 1:], rotmat[:, :1])
    with span("project"):
        trans = cam_crop_to_full(out.cam.reshape(B, 2, 3), bb, intr, images.shape[2])
        eye = torch.eye(3, dtype=trans.dtype, device=trans.device).expand(B, 2, 3, 3)
        _, j2d = cam_frame_and_project(eye, trans, body.joints.reshape(B, 2, -1, 3), intr,
                                       intr[..., [0, 1], [0, 1]])
    return body.vertices.reshape(B, 2, -1, 3), j2d


class PerceivedPersons(NamedTuple):
    """Every person of a ``perceive_multihmr`` call, in order of their image."""

    vertices: torch.Tensor   # (P, V, 3) camera frame
    j2d: torch.Tensor        # (P, 127, 2) pixels
    trans: torch.Tensor      # (P, 3) camera frame
    index: torch.Tensor      # (P, 2) int64: (frame, view)
    scores: torch.Tensor     # (B, views, gh, gw) detection's score map


@torch.no_grad()
def perceive_multihmr(
    model: MultiHMR,
    smplx_params: SMPLXParams,
    frames: torch.Tensor,               # (B, 2, S, S, 3) RGB 0-255
    intr: torch.Tensor,                 # (B, 2, 3, 3)
    centres: Optional[Persons] = None,  # the persons' patches (models.multihmr.persons_from_centres)
) -> PerceivedPersons:
    """Multi-HMR over both drones' whole frames → every person's whole-body
    SMPL-X vertices and 2D joints in the camera frame, translation and
    (frame, view), and the score map. With ``centres`` the queries sit at
    the given persons (images indexed frame · 2 + view); without, at those
    detection finds. Runs where its inputs are, as ``perceive``."""
    B, views = frames.shape[:2]
    x = frames.reshape((B * views,) + frames.shape[2:])
    K = intr.reshape(B * views, 3, 3)
    with span("vit"):
        tokens = model.backbone(model.normalise(x))
    with span("detect"):
        scores, persons, uv = model.detect(tokens, centres)
        scores = scores.reshape((B, views) + scores.shape[1:])
    index = torch.stack([persons.image // views, persons.image % views], dim=-1)
    with span("hph"):
        pose6d, betas, expression, depth = model.head(tokens, K, persons)
        rot = rot6d_to_rotmat(pose6d.reshape(-1, NUM_POSE_JOINTS, 6))
    if persons.count == 0:
        V = smplx_params.v_template.shape[0]
        J = (smplx_params.j_regressor.shape[0] + smplx_params.extra_joint_ids.shape[0]
             + smplx_params.lmk_bary.shape[0])
        e = tokens.new_zeros(0, 1, 1)
        return PerceivedPersons(e.expand(0, V, 3), e.expand(0, J, 2), e[:, 0].expand(0, 3),
                                index, scores)
    with span("smplx"):
        body = smplx_forward(smplx_params, betas, rot[:, 1:22], rot[:, :1],
                             jaw_pose=rot[:, 22:23], hand_pose=rot[:, 23:],
                             expression=expression)
    with span("project"):
        k = K[persons.image]
        trans = backproject(uv, depth, k)
        cam_j = body.joints + trans[:, None]
        f = torch.stack([k[:, 0, 0], k[:, 1, 1]], dim=-1)[:, None]
        j2d = cam_j[..., :2] / cam_j[..., 2:] * f + k[:, None, :2, 2]
    return PerceivedPersons(body.vertices + trans[:, None], j2d, trans, index, scores)


def build_perception(device=None, seed: int = 0, num_vertices: int = 10475,
                     trunk: str = "bf16") -> Tuple[AirPoseTwoView, SMPLXParams, Features]:
    """The bf16 AirPoseTwoView (random weights from ``seed``) in eval mode,
    the synthetic SMPL-X model and ``trunk``'s features function, on
    ``device`` (``None`` → CUDA; raises without it). The int8 trunks
    calibrate on the two 224² crops of ``bench_inputs``' first frame, as the
    root bench does."""
    dev = resolve_device(device)
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=seed).to(dev)
    smplx_params = synthetic_smplx_params(num_vertices=num_vertices).to(dev)
    calib = None
    if trunk != "bf16":
        calib = bench_inputs(1, dev)[0][0]
    return model, smplx_params, chain_ops(model, trunk, calib)


def bench_inputs(batch: int, device=None, seed: int = 0, crop: int = C.CROP_SIZE):
    """The root bench.py's inputs: normal(0, 1) crops from
    ``np.random.default_rng(seed)``, zero boxes, every person 10 m out, the
    synthetic camera. → (images, bb, init_position, intr) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.normal(size=(batch, 2, crop, crop, 3)).astype(np.float32)).to(dev)
    bb = torch.zeros((batch, 2, 3), device=dev)
    init_position = torch.full((batch, 2, 3), 10.0 * C.TRANS_SCALE, device=dev)
    fx, fy = C.FOCAL_LENGTH
    intr = torch.tensor([[fx, 0, C.CX], [0, fy, C.CY], [0, 0, 1.0]],
                        device=dev).expand(batch, 2, 3, 3)
    return images, bb, init_position, intr
