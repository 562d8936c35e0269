"""Robustifiers for optimization losses (port of airpose_tpu/geometry/robust.py)."""

import torch


def geman_mcclure(residual: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman–McClure penalty ρ(r) = r² / (r² + σ²), saturating at 1 (the
    AirPose+ prior weights were tuned against this scale)."""
    sq = residual * residual
    return sq / (sq + sigma * sigma)
