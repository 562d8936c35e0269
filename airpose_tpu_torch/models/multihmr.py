"""Multi-HMR (Baradel et al., "Multi-HMR: Multi-Person Whole-Body Human Mesh
Recovery in a Single Shot", ECCV 2024, arXiv:2402.14654; github.com/naver/
multi-hmr, ``multiHMR_896_L``): one pass over a whole frame finds every
person in it and regresses a whole-body SMPL-X for each, in the camera's
own frame, without a per-person crop.

* Backbone: DINOv2's ViT-L/14 (``models/vit.py`` with ``dinov2_grid`` 37:
  the CLS token, LayerScale, a 37² stored position embedding): an 896²
  frame cut into 64×64 patches of 14², 4,096 patch tokens and the CLS
  token (T = 4,097) of width 1,024, 24 blocks of 16 heads of 64, in the
  ViT's mixed precision (bf16 linears and attention, float32 residual
  stream).
* Camera embedding: at each patch centre (u, v) the ray
  d = normalise(K⁻¹[u, v, 1]), encoded as [d, sin(π f d), cos(π f d)] over
  ``bands`` frequencies f = linspace(1, ``max_resolution`` / 2), and
  concatenated to the token (1,024 + 3·(1 + 2·bands) wide). The CLS token
  takes the ray through the frame's centre.
* Detection: ``mlp_classif`` (1,024 → 1,024 → 1, ReLU) scores each patch
  token, sigmoid; a 3×3 max-pool keeps the local maxima (NMS) and
  ``threshold`` the people. ``mlp_offset`` (1,024 → 1,024 → 2) gives each
  person's sub-patch offset, sigmoid: its centre is
  ((col + σ(o_u))·14, (row + σ(o_v))·14) in pixels.
* Human Prediction Head (``x_attention_head``): one query a person, the
  embedded token at its patch (camera embedding included) plus the embedded
  mean parameters; ``xat_depth`` pre-norm blocks of ``models/hmr2.py``'s
  ``TransformerCrossAttn`` (self-attention among one image's persons,
  cross-attention into that image's T tokens with their camera embedding,
  an MLP); readouts added to the mean parameters: 53 joints in 6D (root,
  21 body, jaw, 30 hand; the port's column-major 6D, as roma's
  ``special_gramschmidt`` of a (3, 2) matrix), 10 betas, 10 expression
  coefficients, and the log-depth: depth = exp(init_depth + decdepth(x)).
  The translation is depth · K⁻¹[u, v, 1] at the person's centre.

Persons are ragged: 0 or more an image, a number that changes from call to
call. The head packs them into ``slots`` query slots an image (the most
persons any image of the call holds); a padded slot attends only to itself
and no real person attends to a padded slot, and the cross-attention sends
each slot only into its own image's tokens, so no real person's outputs
depend on another image's persons or on the padding. ``persons`` and
``query_slots`` count the real queries and the slots computed (padding
included) over every call.

Where the queries come from: ``Persons`` given to the call (the published
model's path for known person locations, ``idx``; in flight the drone's
tracker), else detection's NMS and threshold. Detection's score map is
computed in every call.

Module names follow the published checkpoint as far as they are known:
``backbone.encoder.`` (DINOv2's own names, with ``last_norm`` for its
``norm`` and no ``mask_token``), ``mlp_classif.{0,2}``, ``mlp_offset.{0,2}``,
``x_attention_head.transformer.layers.{i}.{0,1,2}`` (as HMR 2.0's decoder),
``x_attention_head.dec{pose,shape,expression}``. The query's embeddings
(``to_token_embedding``, ``embed_init``), the depth readout ``decdepth``
and the mean-parameter buffers (``init_body_pose``, ``init_betas``,
``init_expression``, ``init_depth``) are named here.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from .. import device_constant
from .hmr2 import DecoderConfig, TransformerCrossAttn
from .vit import ViT, ViTConfig

NUM_POSE_JOINTS = 53          # root, 21 body, jaw, 30 hand
NUM_BETAS = 10
NUM_EXPRESSION = 10
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class MultiHMRConfig:
    """The model's sizes; the defaults are ``multiHMR_896_L``'s (the head's
    and the camera embedding's as assumed in
    ``benchmark/configs/multihmr_vitl896.json``)."""

    vit: ViTConfig = ViTConfig(img_size=(896, 896), patch=14, width=1024, depth=24, heads=16,
                               mlp_ratio=4, padding=0, dinov2_grid=37)
    head_dim: int = 1024
    xat_depth: int = 2
    xat_heads: int = 8
    xat_dim_head: int = 64
    xat_mlp_dim: int = 1024
    bands: int = 16
    max_resolution: int = 64
    threshold: float = 0.5

    @property
    def camera_dim(self) -> int:
        return 3 * (1 + 2 * self.bands)

    @property
    def context_dim(self) -> int:
        return self.vit.width + self.camera_dim

    @property
    def decoder(self) -> DecoderConfig:
        return DecoderConfig(dim=self.head_dim, depth=self.xat_depth, heads=self.xat_heads,
                             dim_head=self.xat_dim_head, mlp_dim=self.xat_mlp_dim,
                             context_dim=self.context_dim)


class Persons(NamedTuple):
    """The persons of one call, in order of their image: the flat image
    index (image = frame · views + view), the patch (row-major in the grid)
    and the slot (rank within its image) of each (P,) int64 on the device;
    on the host, how many persons there are and the most any image holds."""

    image: torch.Tensor
    patch: torch.Tensor
    slot: torch.Tensor
    count: int
    slots: int


def persons_at(image: torch.Tensor, patch: torch.Tensor, num_images: int,
               slots: Optional[int] = None) -> Persons:
    """``Persons`` from each person's image (sorted) and patch. ``slots``
    (the most persons an image holds) is read back from the device unless
    the caller knows it."""
    counts = torch.zeros(num_images, dtype=torch.int64, device=image.device)
    counts.index_add_(0, image, torch.ones_like(image))
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(image.shape[0], device=image.device) - first[image]
    if slots is None:
        slots = int(counts.max()) if num_images else 0
    return Persons(image, patch, slot, int(image.shape[0]), slots)


def persons_from_centres(uv: torch.Tensor, image: torch.Tensor, num_images: int, patch: int,
                         grid: int, slots: Optional[int] = None) -> Persons:
    """``Persons`` at pixel centres ``uv`` (P, 2) of images ``image`` (P,),
    sorted by image: each person's query sits at the patch holding its
    centre."""
    col = (uv[:, 0] / patch).long().clamp_(0, grid - 1)
    row = (uv[:, 1] / patch).long().clamp_(0, grid - 1)
    return persons_at(image, row * grid + col, num_images, slots)


class MultiHMROutput(NamedTuple):
    scores: torch.Tensor      # (N, gh, gw) detection scores, sigmoid
    persons: Persons
    pose6d: torch.Tensor      # (P, 53·6) the port's column-major 6D
    betas: torch.Tensor       # (P, 10)
    expression: torch.Tensor  # (P, 10)
    depth: torch.Tensor       # (P,)
    uv: torch.Tensor          # (P, 2) the persons' centres, pixels


def regression_mlp(dims) -> nn.Sequential:
    """Linear layers of ``dims`` with a ReLU between each two."""
    layers = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        layers.append(nn.Linear(a, b))
        if i < len(dims) - 2:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class Dinov2Backbone(nn.Module):
    """The published wrapper: ``encoder`` is DINOv2's ViT."""

    def __init__(self, cfg: ViTConfig, dtype, generator=None):
        super().__init__()
        self.encoder = ViT(cfg, dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class HPH(nn.Module):
    """The Human Prediction Head over padded query slots."""

    def __init__(self, cfg: MultiHMRConfig, generator=None):
        super().__init__()
        D = cfg.head_dim
        n_params = NUM_POSE_JOINTS * 6 + NUM_BETAS + NUM_EXPRESSION
        self.to_token_embedding = nn.Linear(cfg.context_dim, D)
        self.embed_init = nn.Linear(n_params, D)
        self.transformer = TransformerCrossAttn(cfg.decoder)
        self.decpose = nn.Linear(D, NUM_POSE_JOINTS * 6)
        self.decshape = nn.Linear(D, NUM_BETAS)
        self.decexpression = nn.Linear(D, NUM_EXPRESSION)
        self.decdepth = nn.Linear(D, 1)
        ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(NUM_POSE_JOINTS)
        self.register_buffer("init_body_pose", ident[None].clone())
        self.register_buffer("init_betas", torch.zeros(1, NUM_BETAS))
        self.register_buffer("init_expression", torch.zeros(1, NUM_EXPRESSION))
        self.register_buffer("init_depth", torch.full((1, 1), 2.3))
        for m in self.modules():
            if isinstance(m, nn.Linear):   # nn.Linear's own draw, from ``generator``
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)

    def mean_params(self) -> torch.Tensor:
        return torch.cat([self.init_body_pose, self.init_betas, self.init_expression], dim=-1)

    def forward(self, context: torch.Tensor, persons: Persons):
        """context (N, T, context_dim) float32, the persons' query tokens at
        1 + patch → (pose6d, betas, expression, depth) of the P persons."""
        N, T, _ = context.shape
        S, P = persons.slots, persons.count
        if P == 0:
            e = context.new_zeros(0, 1)
            return (e.expand(0, NUM_POSE_JOINTS * 6), e.expand(0, NUM_BETAS),
                    e.expand(0, NUM_EXPRESSION), e[:, 0])
        tok = context[persons.image, 1 + persons.patch]                      # (P, context_dim)
        q = self.to_token_embedding(tok) + self.embed_init(self.mean_params())
        x = q.new_zeros(N, S, q.shape[-1])
        x[persons.image, persons.slot] = q
        counts = torch.zeros(N, dtype=torch.int64, device=context.device)
        counts.index_add_(0, persons.image, torch.ones_like(persons.image))
        real = torch.arange(S, device=context.device)[None, :] < counts[:, None]   # (N, S)
        mask = real[:, None, :] | torch.eye(S, dtype=torch.bool, device=context.device)
        out = self.transformer(x, context, mask[:, None])[persons.image, persons.slot]
        return (self.decpose(out) + self.init_body_pose,
                self.decshape(out) + self.init_betas,
                self.decexpression(out) + self.init_expression,
                torch.exp(self.decdepth(out) + self.init_depth)[:, 0])


class MultiHMR(nn.Module):
    """``forward(frames (N, S, S, 3) RGB 0-255, intr (N, 3, 3), persons=None)
    → MultiHMROutput``: the backbone in ``dtype``, detection, the head and
    its readouts in float32. ``attention_calls`` counts every attention the
    model has run (24 + 2·xat_depth a forward with persons)."""

    def __init__(self, dtype=torch.bfloat16, seed: int = 0,
                 cfg: MultiHMRConfig = MultiHMRConfig()):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        g = torch.Generator().manual_seed(seed)
        self.backbone = Dinov2Backbone(cfg.vit, dtype, generator=g)
        C = cfg.vit.width
        self.mlp_classif = regression_mlp([C, C, 1])
        self.mlp_offset = regression_mlp([C, C, 2])
        for mlp in (self.mlp_classif, self.mlp_offset):
            for m in mlp:
                if isinstance(m, nn.Linear):
                    bound = m.in_features ** -0.5
                    nn.init.uniform_(m.weight, -bound, bound, generator=g)
                    nn.init.uniform_(m.bias, -bound, bound, generator=g)
        self.x_attention_head = HPH(cfg, generator=g)
        self.persons = 0
        self.query_slots = 0

    @property
    def attention_calls(self) -> int:
        return sum(m.calls for m in self.modules() if hasattr(m, "calls"))

    @property
    def grid(self) -> int:
        return self.cfg.vit.grid[1]

    def normalise(self, frames: torch.Tensor) -> torch.Tensor:
        """RGB 0-255 → ImageNet-normalised float32, as DINOv2 takes it."""
        mean = device_constant(tuple(255.0 * m for m in IMG_MEAN), torch.float32, frames.device)
        inv_std = device_constant(tuple(1.0 / (255.0 * s) for s in IMG_STD), torch.float32,
                                  frames.device)
        return (frames.float() - mean) * inv_std

    def camera_embedding(self, intr: torch.Tensor) -> torch.Tensor:
        """intr (N, 3, 3) → the Fourier features of each token's ray
        (N, T, camera_dim), the CLS token's first."""
        cfg, dev = self.cfg, intr.device
        p, (gh, gw) = cfg.vit.patch, cfg.vit.grid
        h, w = cfg.vit.img_size
        rows = (torch.arange(gh, device=dev, dtype=torch.float32) + 0.5) * p
        cols = (torch.arange(gw, device=dev, dtype=torch.float32) + 0.5) * p
        u = torch.cat([torch.full((1,), w / 2.0, device=dev), cols.repeat(gh)])
        v = torch.cat([torch.full((1,), h / 2.0, device=dev), rows.repeat_interleave(gw)])
        k = intr.float()[:, None]
        d = torch.stack([(u - k[..., 0, 2]) / k[..., 0, 0], (v - k[..., 1, 2]) / k[..., 1, 1],
                         torch.ones_like(u).expand(intr.shape[0], -1)], dim=-1)
        d = F.normalize(d, dim=-1)                                           # (N, T, 3)
        f = torch.linspace(1.0, cfg.max_resolution / 2, cfg.bands, device=dev)
        x = (torch.pi * d[..., None] * f).flatten(-2)                        # (N, T, 3·bands)
        return torch.cat([d, torch.sin(x), torch.cos(x)], dim=-1)

    def detect(self, tokens: torch.Tensor, persons: Optional[Persons] = None):
        """tokens (N, T, C) → (score map (N, gh, gw), Persons, centres
        (P, 2)): the persons given, else those NMS and the threshold keep."""
        N, gh, gw = tokens.shape[0], *self.cfg.vit.grid
        # the CLS token's score is computed and dropped: a slice of the
        # tokens would cost the linear a copy of them
        scores = torch.sigmoid(self.mlp_classif(tokens)[:, 1:, 0]).reshape(N, gh, gw)
        if persons is None:
            peak = F.max_pool2d(scores[:, None], 3, stride=1, padding=1)[:, 0]
            keep = ((scores == peak) & (scores > self.cfg.threshold)).flatten().nonzero()[:, 0]
            persons = persons_at(keep // (gh * gw), keep % (gh * gw), N)
        off = torch.sigmoid(self.mlp_offset(tokens[persons.image, 1 + persons.patch]))
        rc = torch.stack([persons.patch % gw, persons.patch // gw], dim=-1)
        return scores, persons, (rc + off) * self.cfg.vit.patch

    def head(self, tokens: torch.Tensor, intr: torch.Tensor, persons: Persons):
        """The HPH on the persons → (pose6d, betas, expression, depth)."""
        self.persons += persons.count
        self.query_slots += tokens.shape[0] * persons.slots
        context = torch.cat([tokens, self.camera_embedding(intr)], dim=-1)
        return self.x_attention_head(context, persons)

    def forward(self, frames: torch.Tensor, intr: torch.Tensor,
                persons: Optional[Persons] = None) -> MultiHMROutput:
        tokens = self.backbone(self.normalise(frames))
        scores, persons, uv = self.detect(tokens, persons)
        return MultiHMROutput(scores, persons, *self.head(tokens, intr, persons), uv)
