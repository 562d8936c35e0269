from .cuda_lbs import skinning, skinning_reference
from .smplx import (
    SMPLXOutput,
    SMPLXParams,
    load_smplx_npz,
    smplx_forward,
    smplx_params_from_numpy,
    synthetic_smplx_params,
)

__all__ = [
    "SMPLXOutput",
    "SMPLXParams",
    "load_smplx_npz",
    "skinning",
    "skinning_reference",
    "smplx_forward",
    "smplx_params_from_numpy",
    "synthetic_smplx_params",
]
