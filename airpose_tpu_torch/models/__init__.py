import torch

from .. import resolve_device
from .airpose import (HMR, AirPoseTwoView, AirPoseTwoViewSep, AirPoseTwoViewSepView,
                      FullCamOutput, MuHMR, SingleViewFullCam, WeakCamOutput, mean_init_state)
from .regressor import RegressorCore, load_mean_params
from .resnet import Bottleneck, ResNet50

MODEL_REGISTRY = {
    "hmr": HMR,
    "copenet_singleview": SingleViewFullCam,
    "muhmr": MuHMR,
    "copenet_twoview": AirPoseTwoView,
    "copenet_twoview_sep": AirPoseTwoViewSep,
}


def family_init_args(family: str, batch_size: int = 1, img_res: int = 224, device=None):
    """Each family's positional forward arguments, as tensors on ``device``
    (CUDA by default): zero images, zero ``bb`` and ``init_position`` 0.5
    where the family takes them, as the JAX package's table has them."""
    dev = resolve_device(device)
    B = batch_size
    img = torch.zeros((B, 2, img_res, img_res, 3), device=dev)
    if family == "hmr":
        return (img[:, 0],)
    if family == "copenet_singleview":
        return (img[:, 0], torch.zeros((B, 3), device=dev), torch.full((B, 3), 0.5, device=dev))
    if family == "muhmr":
        return (img,)
    if family in ("copenet_twoview", "copenet_twoview_sep"):
        return (img, torch.zeros((B, 2, 3), device=dev), torch.full((B, 2, 3), 0.5, device=dev))
    raise ValueError(f"unknown model family: {family}")


__all__ = ["AirPoseTwoView", "AirPoseTwoViewSep", "AirPoseTwoViewSepView", "Bottleneck",
           "FullCamOutput", "HMR", "MODEL_REGISTRY", "MuHMR", "RegressorCore", "ResNet50",
           "SingleViewFullCam", "WeakCamOutput", "family_init_args", "load_mean_params",
           "mean_init_state"]
