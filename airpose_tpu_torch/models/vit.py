"""ViT backbone of HMR 2.0 (ViTPose's ViT-H/16; 4D-Humans
``hmr2/models/backbones/vit.py``).

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
to the math path raises. Each attention module counts its calls in
``calls``.
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over (B, H, N, d) on the flash or memory-efficient
    backend; raises where neither takes the inputs."""
    with sdpa_kernel(FAST_SDPA):
        return F.scaled_dot_product_attention(q, k, v)


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
    """The backbone's sizes; the defaults are ViT-H/16 at HMR 2.0's 256×192."""

    img_size: Tuple[int, int] = (256, 192)
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp_ratio: int = 4
    padding: int = 2

    @property
    def grid(self) -> Tuple[int, int]:
        """Patch rows and columns the convolution gives."""
        return tuple((s + 2 * self.padding - self.patch) // self.patch + 1
                     for s in self.img_size)

    @property
    def tokens(self) -> int:
        return self.grid[0] * self.grid[1]


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
        return linear(merge_heads(attention(q, k, v)), self.proj)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


def norm_point(x: torch.Tensor, branch: Optional[torch.Tensor], norm: nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """``x += branch`` on the float32 residual stream (unless ``branch`` is
    None), then ``norm`` over ``x`` in float32, cast to ``dtype``."""
    return add_layernorm(x, branch, norm.weight, norm.bias, norm.eps, dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=1e-6)
        self.attn = Attention(cfg.width, cfg.heads)
        self.norm2 = nn.LayerNorm(cfg.width, eps=1e-6)
        self.mlp = Mlp(cfg.width, cfg.mlp_ratio * cfg.width)

    def forward(self, x: torch.Tensor, branch: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        """Adds the previous block's pending ``branch`` to the float32
        residual stream ``x`` (B, N, C) in place, then runs this block; its
        MLP branch is returned, not yet added."""
        x_attn = self.attn(norm_point(x, branch, self.norm1, dtype))
        return self.mlp(norm_point(x, x_attn, self.norm2, dtype))


def _init_linear_(m: nn.Linear, generator) -> None:
    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
    nn.init.zeros_(m.bias)


class ViT(nn.Module):
    """``forward(x (B, H, W, 3)) → tokens (B, N, width)`` float32, the
    crop's ``cfg.img_size`` rows and columns. Weights are drawn as
    ViTPose's ``init_weights`` draws them (truncated normal of std 0.02 for
    the linears and ``pos_embed``, zero biases, LayerNorm 1 and 0; the patch
    convolution keeps PyTorch's default) from ``generator``."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.tokens + 1, cfg.width))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.width, eps=1e-6)
        fan_in = 3 * cfg.patch * cfg.patch
        for t in (self.patch_embed.proj.weight, self.patch_embed.proj.bias):
            nn.init.uniform_(t, -fan_in ** -0.5, fan_in ** -0.5, generator=generator)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _init_linear_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("patch_embed"):
            pos = self.pos_embed[:, 1:] + self.pos_embed[:, :1]
            h = self.patch_embed(x.to(self.dtype)).float() + pos
        with span("vit_blocks"):
            branch = None
            for blk in self.blocks:
                branch = blk(h, branch, self.dtype)
            return norm_point(h, branch, self.last_norm, torch.float32)
