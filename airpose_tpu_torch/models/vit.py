"""ViT backbones: HMR 2.0's (ViTPose's ViT-H/16; 4D-Humans
``hmr2/models/backbones/vit.py``) and, through ``ViTConfig``'s DINOv2
switch, Multi-HMR's (DINOv2's ViT-L/14; facebookresearch/dinov2
``dinov2/models/vision_transformer.py``, ``layers/block.py``).

  tokens = PatchEmbed(x) + pos_embed[:, 1:] + pos_embed[:, :1]
  x      = x + Attn(LN1(x));  x = x + MLP(LN2(x))          (each of ``depth`` blocks)
  out    = LN(x)                                          (``last_norm``)

PatchEmbed is a ``patch``×``patch`` convolution of stride ``patch`` and
padding 2, so a 256×192 crop gives 16×12 = 192 tokens. Attention has
``heads`` heads of ``width / heads`` with a biased qkv; the MLP is
width → ``mlp_ratio``·width → width with the exact GELU; LayerNorm eps is
1e-6. Module names follow the published state dict (``patch_embed.proj``,
``pos_embed``, ``blocks.{i}.norm1``, ``.attn.qkv``, ``.attn.proj``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``last_norm``). Drop path is a
training-only regulariser and absent here.

The dtype policy is the mixed precision HMR 2.0 trains in: parameters stay
float32 and are cast at the call; the patch convolution, every linear and
the attention run in ``dtype`` (bf16 on the card); the residual stream and
the LayerNorm statistics stay float32. Each residual add is fused with the
LayerNorm that follows it and the cast of its output
(``ops/add_layernorm.py``; one kernel launch on the card): a block adds the
previous block's MLP branch at its ``norm1`` and its own attention branch at
its ``norm2``, and returns its MLP branch still to be added, which the next
block's ``norm1`` or ``last_norm`` takes. That makes 2·depth + 1 norm points
a forward. Attention goes through
``F.scaled_dot_product_attention`` restricted to the flash and
memory-efficient backends (``attention``), so an input that would fall back
to the math path raises; a block's attention runs inside an ``attention``
span. Each attention module counts its calls in ``calls``.

DINOv2's variant (``dinov2_grid`` set, no padding; Oquab et al.,
arXiv:2304.07193):

  tokens = [cls_token + pos_embed[:, :1];  PatchEmbed(x) + bicubic(pos_embed[:, 1:] → grid)]
  x      = x + γ₁ ⊙ Attn(LN1(x));  x = x + γ₂ ⊙ MLP(LN2(x))   (LayerScale ``ls1.gamma``, ``ls2.gamma``)
  out    = LN(x)

The position embedding is stored as published, a ``dinov2_grid``² grid
plus the CLS entry (37² + 1 at DINOv2's 518² pre-training), and interpolated to
the image's patch grid once for the weights it holds (cached against the
parameter's version), not at every call. DINOv2 passes a scale factor of
(grid + 0.1) / dinov2_grid to the bicubic interpolation, which moves its
sample points by a fraction of a patch; here the output size is given
instead. LayerScale goes into the fused norm point with its branch (one
launch a norm point, as without it). DINOv2's final norm ``norm`` is
``last_norm`` here, and its ``mask_token`` (masked pre-training only) is
absent.
"""

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.add_layernorm import add_layernorm
from ..utils.profiling import span

FAST_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over (B, H, N, d) on the flash or memory-efficient
    backend; raises where neither takes the inputs. ``mask`` (boolean,
    broadcast to (B, H, Nq, Nk)) keeps the keys where it is true; a masked
    call runs on the memory-efficient backend."""
    with sdpa_kernel(FAST_SDPA):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H·d) → (B, H, N, d), a view."""
    B, N, _ = t.shape
    return t.view(B, N, heads, -1).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) → (B, N, H·d)."""
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in ``x``'s dtype, its float32 parameters cast at the call."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The backbone's sizes; the defaults are ViT-H/16 at HMR 2.0's 256×192.
    ``dinov2_grid`` set makes it DINOv2's: a CLS token, LayerScale on both
    branches, and the position embedding stored on a ``dinov2_grid``² grid
    (None: ViTPose's, no CLS token or LayerScale, the position embedding on
    the patch grid itself)."""

    img_size: Tuple[int, int] = (256, 192)
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp_ratio: int = 4
    padding: int = 2
    dinov2_grid: Optional[int] = None

    @property
    def dinov2(self) -> bool:
        return self.dinov2_grid is not None

    @property
    def grid(self) -> Tuple[int, int]:
        """Patch rows and columns the convolution gives."""
        return tuple((s + 2 * self.padding - self.patch) // self.patch + 1
                     for s in self.img_size)

    @property
    def patches(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def tokens(self) -> int:
        """Tokens out of the backbone: the patches and the CLS token if any."""
        return self.patches + int(self.dinov2)

    @property
    def pos_entries(self) -> int:
        """Rows of ``pos_embed``: the stored grid and the CLS entry."""
        return (self.dinov2_grid ** 2 if self.dinov2 else self.patches) + 1


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.padding = cfg.padding
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch, stride=cfg.patch, padding=cfg.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, N, width) in ``x``'s dtype."""
        w, b = self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype)
        h = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.proj.stride,
                     padding=self.padding)
        # token-major once here: the residual stream keeps this layout, and a
        # channel-major one costs every LayerNorm a copy and every add its
        # vectorised kernel (29 of 117 ms a 128-crop call on the H100)
        return h.flatten(2).transpose(1, 2).contiguous()


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.calls = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = linear(x, self.qkv).view(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        self.calls += 1
        with span("attention"):
            out = attention(q, k, v)
        return linear(merge_heads(out), self.proj)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


def norm_point(x: torch.Tensor, branch: Optional[torch.Tensor], norm: nn.LayerNorm,
               dtype: torch.dtype, gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x += branch`` (``x += gamma * branch`` with a LayerScale ``gamma``)
    on the float32 residual stream (unless ``branch`` is None), then
    ``norm`` over ``x`` in float32, cast to ``dtype``."""
    return add_layernorm(x, branch, norm.weight, norm.bias, norm.eps, dtype, gamma)


class LayerScale(nn.Module):
    """DINOv2's per-channel scale of a branch, ``gamma`` (C,)."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(width))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=1e-6)
        self.attn = Attention(cfg.width, cfg.heads)
        self.norm2 = nn.LayerNorm(cfg.width, eps=1e-6)
        self.mlp = Mlp(cfg.width, cfg.mlp_ratio * cfg.width)
        self.ls1 = LayerScale(cfg.width) if cfg.dinov2 else None
        self.ls2 = LayerScale(cfg.width) if cfg.dinov2 else None

    @property
    def gamma1(self) -> Optional[torch.Tensor]:
        return None if self.ls1 is None else self.ls1.gamma

    @property
    def gamma2(self) -> Optional[torch.Tensor]:
        return None if self.ls2 is None else self.ls2.gamma

    def forward(self, x: torch.Tensor, branch: Optional[torch.Tensor],
                gamma: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        """Adds the previous block's pending ``branch`` (scaled by its
        ``gamma``, if any) to the float32 residual stream ``x`` (B, N, C) in
        place, then runs this block; its MLP branch is returned, not yet
        added (its scale is ``gamma2``)."""
        x_attn = self.attn(norm_point(x, branch, self.norm1, dtype, gamma))
        return self.mlp(norm_point(x, x_attn, self.norm2, dtype, self.gamma1))


def _init_linear_(m: nn.Linear, generator) -> None:
    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
    nn.init.zeros_(m.bias)


class ViT(nn.Module):
    """``forward(x (B, H, W, 3)) → tokens (B, N, width)`` float32, the
    crop's ``cfg.img_size`` rows and columns (DINOv2's with the CLS token
    first). Weights are drawn as ViTPose's ``init_weights`` draws them
    (truncated normal of std 0.02 for the linears, ``pos_embed`` and the CLS
    token, zero biases, LayerNorm 1 and 0, LayerScale at DINOv2's 1e-5; the
    patch convolution keeps PyTorch's default) from ``generator``."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch_embed = PatchEmbed(cfg)
        if cfg.dinov2:
            self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.pos_entries, cfg.width))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.width, eps=1e-6)
        self._grid_pos = (None, None)   # (key, the position embedding on the patch grid)
        fan_in = 3 * cfg.patch * cfg.patch
        for t in (self.patch_embed.proj.weight, self.patch_embed.proj.bias):
            nn.init.uniform_(t, -fan_in ** -0.5, fan_in ** -0.5, generator=generator)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
        if cfg.dinov2:
            nn.init.trunc_normal_(self.cls_token, std=0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _init_linear_(m, generator)
            elif isinstance(m, LayerScale):
                nn.init.constant_(m.gamma, 1e-5)

    def grid_pos(self) -> torch.Tensor:
        """DINOv2's stored ``dinov2_grid``² position embedding, bicubically
        interpolated to the patch grid → (1, patches, width) float32;
        computed once for the weights ``pos_embed`` holds (again after any
        write to it) and kept."""
        p = self.pos_embed
        key = (p.device, p.data_ptr(), p._version)
        if self._grid_pos[0] == key:
            return self._grid_pos[1]
        n, (gh, gw) = self.cfg.dinov2_grid, self.cfg.grid
        with torch.no_grad():
            stored = p[:, 1:].float().reshape(1, n, n, -1).permute(0, 3, 1, 2)
            grid = F.interpolate(stored, size=(gh, gw), mode="bicubic", align_corners=False)
            grid = grid.flatten(2).transpose(1, 2).contiguous()
        self._grid_pos = (key, grid)
        return grid

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → the float32 residual stream (B, tokens, width)."""
        h = self.patch_embed(x.to(self.dtype)).float()
        if not self.cfg.dinov2:
            return h + (self.pos_embed[:, 1:] + self.pos_embed[:, :1])
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(h.shape[0], 1, h.shape[2])
        return torch.cat([cls, h + self.grid_pos()], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("patch_embed"):
            h = self.embed(x)
        with span("vit_blocks"):
            branch = gamma = None
            for blk in self.blocks:
                branch, gamma = blk(h, branch, gamma, self.dtype), blk.gamma2
            return norm_point(h, branch, self.last_norm, torch.float32, gamma)
