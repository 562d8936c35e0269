from .projection import (estimate_translation, lstsq_triangulation, perspective_projection,
                         transform_points, transform_smpl, weak_cam_crop_to_full_trans,
                         weak_cam_from_position, weak_cam_to_trans)
from .robust import geman_mcclure
from .rotations import (batch_rodrigues, quat_to_rotmat, rot6d_to_rotmat, rotmat_to_aa,
                        rotmat_to_quat, rotmat_to_rot6d)

__all__ = ["batch_rodrigues", "estimate_translation", "geman_mcclure",
           "lstsq_triangulation", "perspective_projection", "quat_to_rotmat",
           "rot6d_to_rotmat", "rotmat_to_aa", "rotmat_to_quat", "rotmat_to_rot6d",
           "transform_points", "transform_smpl", "weak_cam_crop_to_full_trans",
           "weak_cam_from_position", "weak_cam_to_trans"]
