"""The multiply-adds a whole step requires, by precision, from the shapes of
its configuration; ``peaks.least_seconds`` turns them into the least time
the chip could take.

* Trunk: the stem and the residual stages' convolutions of every crop.
* Regressor: per IEF step and row, fc1 (fc1_in × hidden), fc2 (hidden ×
  hidden) and the heads (hidden × their widths), float32.
* SMPL-X per body, float32: the shape blend (V·3·betas), the joint
  regressor (J·V·3), the pose blend ((J − 1)·9 × V·3), and the skinning,
  whose transforms are the 12 used entries of Σ_j w_vj A_j (V·J·12) applied
  to each vertex (V·9). The rigid chain, the 6D conversion, the
  landmarks and the projection are left out (each below 0.1% of the rest).

Training counts each product of a parameter with an activation three
times (forward, the gradient of the activation, the gradient of the
parameter) and twice where only one gradient exists: the stem, whose input
takes none, and SMPL-X's products with its constant model tensors. The
optimizer's elementwise work is not counted. An int8 step counts its
residual-stage convolutions at the int8 peak and its stem in bf16.
Operations are 2 per multiply-add.
"""

from typing import Dict, Mapping

from . import resnet

TRUNK_PRECISION = {"bfloat16": "bf16", "float32": "fp32"}


def regressor_macs(cfg: Mapping) -> int:
    """Multiply-adds of one IEF step of one row."""
    h = cfg["fc_hidden"]
    return cfg["fc1_in"] * h + h * h + h * sum(cfg["heads"].values())


def smplx_macs(body: Mapping) -> int:
    """Multiply-adds of one body's SMPL-X forward."""
    V, J, S = body["num_vertices"], body["num_joints"], body["num_betas"]
    return V * 3 * S + J * V * 3 + (J - 1) * 9 * V * 3 + V * J * 12 + V * 9


def perceive_ops(cfg: Mapping, batch: int, trunk: str = "int8") -> Dict[str, float]:
    """Operations of one perception call on ``batch`` two-view frames."""
    crops = batch * cfg["views"]
    stem, layers = resnet.trunk_macs(cfg["trunk"], cfg["crop"])
    body_layers = "int8" if trunk == "int8" else "bf16"
    ops = {"bf16": 2.0 * crops * stem, body_layers: 0.0, "fp32": 0.0}
    ops[body_layers] += 2.0 * crops * layers
    ops["fp32"] = 2.0 * crops * (cfg["ief_iters"] * regressor_macs(cfg) + smplx_macs(cfg["smplx"]))
    return ops


def train_ops(cfg: Mapping, batch: int) -> Dict[str, float]:
    """Operations of one training step on ``batch`` samples (each of
    ``views`` crops through the trunk and as many bodies)."""
    crops = batch * cfg["views"]
    stem, layers = resnet.trunk_macs(cfg["trunk"], cfg["crop"])
    ops = {"bf16": 0.0, "fp32": 2.0 * crops * (3 * cfg["ief_iters"] * regressor_macs(cfg)
                                               + 2 * smplx_macs(cfg["smplx"]))}
    ops[TRUNK_PRECISION[cfg["trunk_dtype"]]] += 2.0 * crops * (2 * stem + 3 * layers)
    return ops
