"""Multi-HMR's work, from its shapes (``configs/multihmr_vitl896.json``) and
the persons of a call.

* Backbone, one frame of T tokens (the patches and the CLS token) of width
  C: ``roofline.vit``'s counts, the patch convolution over the patches
  alone and each block over all T tokens (its linears and the attention
  products QKᵀ and AV, 2 · T² · C over all heads). LayerScale, like
  LayerNorm, GELU, softmax and the residual adds, is elementwise and not
  counted.
* Detection, one frame: the score MLP on every patch (C · hidden + hidden);
  the offset MLP on each person's patch (C · hidden + 2 · hidden).
* Head: of each frame that holds persons, the cross-attention's k and v
  over its T context tokens in each layer; of each real person, the
  query's token embedding, in each layer the self-attention's qkv, its
  products with the n persons of its frame and its output, the
  cross-attention's q, products and output, the MLP; the readouts. The
  mean parameters' embedding is one product a call. Padded query slots are
  not required work and are not counted.
* SMPL-X, one person: ``roofline.step.smplx_macs`` and the expression's
  blend shapes (V · 3 · E).

Operations are 2 per multiply-add.
"""

from typing import Dict, Mapping, Sequence

from . import step, vit


def attention_macs(vb: Mapping) -> int:
    """QKᵀ and AV of one block of one frame, over all heads."""
    return 2 * vb["tokens"] ** 2 * vb["width"]


def backbone_macs(vb: Mapping) -> int:
    """One frame: the patch convolution over the patches (not the CLS
    token) and ``depth`` blocks over all tokens."""
    return vit.patch_macs(dict(vb, tokens=vb["patches"])) + vb["depth"] * vit.block_macs(vb)


def detection_macs(cfg: Mapping, persons: int) -> int:
    """One frame's score map and ``persons`` offsets."""
    C, h = cfg["backbone"]["width"], cfg["detection"]["hidden"]
    return cfg["backbone"]["patches"] * (C * h + h) + persons * (C * h + 2 * h)


def head_macs(cfg: Mapping, persons: Sequence[int]) -> int:
    """The head over one frame's ``persons[i]`` real persons a frame, for
    each frame of a call, and the call's one embedding of the mean
    parameters."""
    hd, T = cfg["head"], cfg["backbone"]["tokens"]
    D, inner, ctx = hd["dim"], hd["heads"] * hd["dim_head"], hd["context_dim"]
    out = cfg["outputs"]
    n_params = out["decpose"] + out["decshape"] + out["decexpression"]
    total = n_params * D
    for n in persons:
        if not n:
            continue
        per_layer = (T * ctx * 2 * inner                                        # k, v
                     + n * (D * 3 * inner + 2 * n * inner + inner * D            # self-attention
                            + D * inner + 2 * T * inner + inner * D              # cross-attention
                            + 2 * D * hd["mlp_dim"]))                            # MLP
        total += n * ctx * D + hd["xat_depth"] * per_layer + n * D * sum(out.values())
    return total


def body_macs(cfg: Mapping) -> int:
    """One person's SMPL-X with its expression."""
    b = cfg["smplx"]
    return step.smplx_macs(b) + b["num_vertices"] * 3 * b["num_expression"]


def call_ops(cfg: Mapping, persons: Sequence[int]) -> Dict[str, float]:
    """Operations of one call whose frames hold ``persons`` persons each:
    the backbone at bf16, detection, the head and SMPL-X at float32."""
    frames, real = len(persons), sum(persons)
    fp32 = frames * detection_macs(cfg, 0) + detection_macs(cfg, real) - detection_macs(cfg, 0)
    fp32 += head_macs(cfg, persons) + real * body_macs(cfg)
    return {"bf16": 2.0 * frames * backbone_macs(cfg["backbone"]), "fp32": 2.0 * fp32}


def attention_ops(cfg: Mapping, frames: int) -> float:
    """Operations of the backbone's QKᵀ and AV over ``frames`` frames:
    4 · T² · C a block a frame."""
    vb = cfg["backbone"]
    return 2.0 * frames * vb["depth"] * attention_macs(vb)
