from .joints import SMPLX_TO_H36M17
from .synthetic import batch_slice, make_synthetic_dataset

__all__ = ["SMPLX_TO_H36M17", "batch_slice", "make_synthetic_dataset"]
