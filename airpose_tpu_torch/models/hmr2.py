"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023; 4D-Humans
``hmr2/models/hmr2.py``, ``heads/smpl_head.py``,
``components/pose_transformer.py``): a ViT-H/16 backbone over the middle
256×192 of a 256² crop and a transformer decoder that reads one query token
out into SMPL's parameters.

The head (``SMPLTransformerDecoderHead``, float32): the zero token of width 1
is embedded by Linear(1 → dim) plus a learned position embedding, then
``depth`` layers each of three residual pre-norm steps:

  x = x + SelfAttn(LN(x))                   heads × dim_head, qkv without bias
  x = x + CrossAttn(LN(x), context=tokens)  q from x, k and v from the backbone's tokens
  x = x + FeedForward(LN(x))                dim → mlp_dim → dim, exact GELU

and ``decpose``, ``decshape``, ``deccam`` add their readings of the token to
the mean parameters (one IEF step): 6D rotations of SMPL's 24 joints, 10
betas and a weak-perspective camera (s, tx, ty). LayerNorm eps is 1e-5.
Module names follow the published state dict (``backbone.``,
``smpl_head.transformer.transformer.layers.{i}.{0,1,2}.norm``, ``.fn.to_qkv``,
``.fn.to_q``, ``.fn.to_kv``, ``.fn.to_out.0``, ``.fn.net.0``, ``.fn.net.3``,
``smpl_head.dec{pose,shape,cam}`` and the buffers ``init_body_pose``,
``init_betas``, ``init_cam``). Weights are drawn as the published modules
draw theirs: the backbone as ViTPose does (``models/vit.py``), the head with
PyTorch's defaults (the position embedding standard normal).

HMR 2.0's 6D layout is (a1, a2), the two columns one after the other
(``x.reshape(-1, 2, 3).permute(0, 2, 1)``); ``pose_rotmats`` reorders it into
the port's column-major layout for the shared ``rot6d_to_rotmat``.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..geometry.rotations import rot6d_to_rotmat
from .regressor import load_mean_params
from .vit import ViT, ViTConfig, attention, merge_heads, split_heads

NUM_SMPL_JOINTS = 24
CROP = 256                # the crop HMR 2.0 takes; its backbone sees columns 32 .. 224
HMR2_TO_PORT_6D = (0, 3, 1, 4, 2, 5)


class HMR2Output(NamedTuple):
    pose6d: torch.Tensor   # (B, 144)  24 joints × 6D, HMR 2.0's layout
    betas: torch.Tensor    # (B, 10)
    cam: torch.Tensor      # (B, 3)    weak perspective (s, tx, ty)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The head's sizes; the defaults are HMR 2.0's."""

    dim: int = 1024
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 1024
    context_dim: int = 1280


def pose_rotmats(pose6d: torch.Tensor) -> torch.Tensor:
    """(..., 24·6) in HMR 2.0's 6D layout → (..., 24, 3, 3)."""
    six = pose6d.reshape(pose6d.shape[:-1] + (-1, 6))[..., list(HMR2_TO_PORT_6D)]
    return rot6d_to_rotmat(six)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.fn(self.norm(x), **kw)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim), nn.Dropout(0.0))
        self.calls = 0

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` (boolean, (B, 1, N, N)): the keys each query may attend
        to; None lets every query attend to every key."""
        q, k, v = (split_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        self.calls += 1
        return self.to_out(merge_heads(attention(q, k, v, mask)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim), nn.Dropout(0.0))
        self.calls = 0

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = (split_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        q = split_heads(self.to_q(x), self.heads)
        self.calls += 1
        return self.to_out(merge_heads(attention(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerCrossAttn(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(cfg.dim, SelfAttention(cfg.dim, cfg.heads, cfg.dim_head)),
            PreNorm(cfg.dim, CrossAttention(cfg.dim, cfg.context_dim, cfg.heads, cfg.dim_head)),
            PreNorm(cfg.dim, FeedForward(cfg.dim, cfg.mlp_dim)),
        ]) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queries ``x`` (B, N, dim) over ``context`` (B, T, context_dim);
        ``mask`` restricts the queries' self-attention (``SelfAttention``)."""
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x, mask=mask) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, token_dim: int = 1):
        super().__init__()
        self.to_token_embedding = nn.Linear(token_dim, cfg.dim)
        self.pos_embedding = nn.Parameter(torch.empty(1, 1, cfg.dim))
        self.transformer = TransformerCrossAttn(cfg)

    def forward(self, token: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class SMPLTransformerDecoderHead(nn.Module):
    """``forward(tokens (B, N, context_dim)) → HMR2Output``, float32."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), generator=None):
        super().__init__()
        self.transformer = TransformerDecoder(cfg)
        self.decpose = nn.Linear(cfg.dim, 6 * NUM_SMPL_JOINTS)
        self.decshape = nn.Linear(cfg.dim, 10)
        self.deccam = nn.Linear(cfg.dim, 3)
        pose, shape, cam = (torch.from_numpy(a)[None] for a in load_mean_params())
        self.register_buffer("init_body_pose", pose)
        self.register_buffer("init_betas", shape)
        self.register_buffer("init_cam", cam)
        for m in self.modules():
            if isinstance(m, nn.Linear):   # nn.Linear's own draw, from ``generator``
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        nn.init.normal_(self.transformer.pos_embedding, generator=generator)

    def forward(self, tokens: torch.Tensor) -> HMR2Output:
        B = tokens.shape[0]
        token = tokens.new_zeros(B, 1, 1)
        out = self.transformer(token, tokens.float())[:, 0]
        return HMR2Output(pose6d=self.decpose(out) + self.init_body_pose,
                          betas=self.decshape(out) + self.init_betas,
                          cam=self.deccam(out) + self.init_cam)


class HMR2(nn.Module):
    """``forward(x (B, 256, 256, 3)) → HMR2Output``: the backbone in
    ``dtype`` over columns 32 .. 224, the head in float32.
    ``attention_calls`` counts every attention the model has run (32 + 6 +
    6 a forward at the published sizes)."""

    def __init__(self, dtype=torch.bfloat16, seed: int = 0, vit: ViTConfig = ViTConfig(),
                 decoder: DecoderConfig = DecoderConfig()):
        super().__init__()
        if decoder.context_dim != vit.width:
            raise ValueError(f"the decoder reads {decoder.context_dim}-wide tokens, "
                             f"the backbone makes {vit.width}")
        g = torch.Generator().manual_seed(seed)
        self.backbone = ViT(vit, dtype, generator=g)
        self.smpl_head = SMPLTransformerDecoderHead(decoder, generator=g)

    @property
    def margin(self) -> int:
        """Columns cut from each side of a square crop: HMR 2.0's 32 of 256,
        in proportion at other sizes."""
        h, w = self.backbone.cfg.img_size
        return (h - w) // 2

    def crop_columns(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) → the backbone's (B, S, S − 2·margin, 3) view."""
        return x[:, :, self.margin:x.shape[2] - self.margin]

    @property
    def attention_calls(self) -> int:
        return sum(m.calls for m in self.modules() if hasattr(m, "calls"))

    def forward(self, x: torch.Tensor) -> HMR2Output:
        return self.smpl_head(self.backbone(self.crop_columns(x)))
