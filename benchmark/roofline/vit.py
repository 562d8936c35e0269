"""HMR 2.0's work, from its shapes (``configs/hmr2_vith.json``).

* Backbone, one crop of T tokens of width C: the patch convolution
  (T · 3p² · C), and in each block the qkv, output, fc1 and fc2 linears
  (T · C · (3C + C + 2rC), r the MLP ratio) and the two attention products
  QKᵀ and AV (2 · T² · C over all heads). LayerNorm, GELU, softmax and
  the residual adds are elementwise and not counted.
* Head, one crop: the token embedding, per layer the self-attention's qkv,
  products and output on one token, the cross-attention's k and v over the
  T context tokens, its q, products and output, the MLP; the readouts.

``vit`` gives (operations, bytes) of the ``vit`` span at ``n`` crops: the
multiply-adds twice, and the bytes every input is read once and every
output written once: the crops' backbone columns (float32), the
backbone's float32 parameters and the float32 tokens. Operations are 2 per
multiply-add.
"""

from typing import Mapping, Tuple


def patch_macs(vb: Mapping) -> int:
    return vb["tokens"] * 3 * vb["patch"] ** 2 * vb["width"]


def block_macs(vb: Mapping) -> int:
    """Multiply-adds of one block of one crop."""
    T, C = vb["tokens"], vb["width"]
    return T * C * (4 * C + 2 * vb["mlp_ratio"] * C) + 2 * T * T * C


def backbone_macs(vb: Mapping) -> int:
    return patch_macs(vb) + vb["depth"] * block_macs(vb)


def backbone_params(vb: Mapping) -> int:
    """The backbone's parameters: the patch convolution, the position
    embedding, each block's two LayerNorms and four linears, the last
    LayerNorm."""
    C, r = vb["width"], vb["mlp_ratio"]
    block = 4 * C + (3 * C * C + 3 * C) + (C * C + C) + (r * C * C + r * C) + (r * C * C + C)
    return (3 * vb["patch"] ** 2 * C + C) + (vb["tokens"] + 1) * C + vb["depth"] * block + 2 * C


def head_macs(cfg: Mapping) -> int:
    """Multiply-adds of the decoder and readouts for one crop."""
    hd, T = cfg["head"], cfg["backbone"]["tokens"]
    D, inner = hd["dim"], hd["heads"] * hd["dim_head"]
    layer = (D * 3 * inner + 2 * inner + inner * D                       # self-attention
             + T * hd["context_dim"] * 2 * inner + D * inner + 2 * T * inner + inner * D
             + 2 * D * hd["mlp_dim"])
    return hd["token_dim"] * D + hd["depth"] * layer + D * sum(cfg["outputs"].values())


def vit(cfg: Mapping, n: int) -> Tuple[float, float]:
    """(operations, bytes) of the ``vit`` span at ``n`` crops."""
    vb = cfg["backbone"]
    h, w = vb["img_size"]
    n_bytes = n * h * w * 3 * 4 + backbone_params(vb) * 4 + n * vb["tokens"] * vb["width"] * 4
    return 2.0 * n * backbone_macs(vb), float(n_bytes)
