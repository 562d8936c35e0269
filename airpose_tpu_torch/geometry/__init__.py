from .rotations import (batch_rodrigues, quat_to_rotmat, rot6d_to_rotmat,
                        rotmat_to_rot6d)

__all__ = ["batch_rodrigues", "quat_to_rotmat", "rot6d_to_rotmat",
           "rotmat_to_rot6d"]
