from .checkpoint import load_reference_state_dict, state_dict_from_flax
from .losses import cam_frame_and_project

__all__ = ["cam_frame_and_project", "load_reference_state_dict",
           "state_dict_from_flax"]
