from .airpose import AirPoseTwoView, FullCamOutput
from .regressor import RegressorCore, load_mean_params
from .resnet import Bottleneck, ResNet50

__all__ = ["AirPoseTwoView", "Bottleneck", "FullCamOutput", "RegressorCore",
           "ResNet50", "load_mean_params"]
