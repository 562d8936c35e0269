from typing import Optional

import torch

from .. import resolve_device
from .airpose import (HMR, AirPoseTwoView, AirPoseTwoViewSep, AirPoseTwoViewSepView,
                      FullCamOutput, MuHMR, SingleViewFullCam, WeakCamOutput, mean_init_state)
from .hmr2 import CROP as HMR2_CROP
from .hmr2 import HMR2, HMR2Output
from .multihmr import MultiHMR, MultiHMROutput
from .regressor import RegressorCore, load_mean_params
from .resnet import Bottleneck, ResNet50

MODEL_REGISTRY = {
    "hmr": HMR,
    "copenet_singleview": SingleViewFullCam,
    "muhmr": MuHMR,
    "copenet_twoview": AirPoseTwoView,
    "copenet_twoview_sep": AirPoseTwoViewSep,
    "hmr2": HMR2,
    "multihmr": MultiHMR,
}


def family_init_args(family: str, batch_size: int = 1, img_res: Optional[int] = None,
                     device=None):
    """Each family's positional forward arguments, as tensors on ``device``
    (CUDA by default): zero images, zero ``bb`` and ``init_position`` 0.5
    where the family takes them, as the JAX package's table has them;
    multihmr's whole frames and a camera of focal length ``img_res`` about
    the frame's centre. ``img_res`` defaults to the family's input: 256 for
    hmr2, 896 for multihmr, else 224."""
    dev = resolve_device(device)
    B = batch_size
    img_res = img_res or {"hmr2": HMR2_CROP, "multihmr": 896}.get(family, 224)
    img = torch.zeros((B, 2, img_res, img_res, 3), device=dev)
    if family in ("hmr", "hmr2"):
        return (img[:, 0],)
    if family == "multihmr":
        K = torch.tensor([[img_res, 0.0, img_res / 2], [0.0, img_res, img_res / 2],
                          [0.0, 0.0, 1.0]], device=dev)
        return (img[:, 0], K.expand(B, 3, 3))
    if family == "copenet_singleview":
        return (img[:, 0], torch.zeros((B, 3), device=dev), torch.full((B, 3), 0.5, device=dev))
    if family == "muhmr":
        return (img,)
    if family in ("copenet_twoview", "copenet_twoview_sep"):
        return (img, torch.zeros((B, 2, 3), device=dev), torch.full((B, 2, 3), 0.5, device=dev))
    raise ValueError(f"unknown model family: {family}")


__all__ = ["AirPoseTwoView", "AirPoseTwoViewSep", "AirPoseTwoViewSepView", "Bottleneck",
           "FullCamOutput", "HMR", "HMR2", "HMR2Output", "MODEL_REGISTRY", "MuHMR",
           "MultiHMR", "MultiHMROutput", "RegressorCore", "ResNet50",
           "SingleViewFullCam", "WeakCamOutput", "family_init_args", "load_mean_params",
           "mean_init_state"]
