from .checkpoint import load_reference_state_dict, state_dict_from_flax
from .losses import (cam_frame_and_project, canonical_smplx_two_view, hmr_loss,
                     joints_loss, muhmr_loss, real_singleview_loss, real_twoview_loss,
                     singleview_loss, twoview_loss)
from .loop import (make_real_singleview_step_fns, make_real_twoview_step_fns,
                   make_singleview_step_fns, make_twoview_step_fns)
from .state import AMSGrad, TrainState, create_train_state, make_optimizer

__all__ = ["AMSGrad", "TrainState", "cam_frame_and_project",
           "canonical_smplx_two_view", "create_train_state", "hmr_loss",
           "joints_loss", "load_reference_state_dict", "make_optimizer",
           "make_real_singleview_step_fns", "make_real_twoview_step_fns",
           "make_singleview_step_fns", "make_twoview_step_fns", "muhmr_loss",
           "real_singleview_loss", "real_twoview_loss", "singleview_loss",
           "state_dict_from_flax", "twoview_loss"]
