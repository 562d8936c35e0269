from .cuda_lbs import skinning, skinning_reference
from .smplx import (
    SMPLXOutput,
    SMPLXParams,
    load_smplx_npz,
    smplx_forward,
    smplx_params_from_numpy,
    synthetic_smplx_params,
)
from .vposer import (
    VPoserParams,
    convert_torch_state_dict,
    init_vposer_params,
    load_vposer_ckpt,
    vposer_decode,
    vposer_encode,
    vposer_params_from_numpy,
    vposer_rsample,
)

__all__ = [
    "SMPLXOutput",
    "SMPLXParams",
    "VPoserParams",
    "convert_torch_state_dict",
    "init_vposer_params",
    "load_vposer_ckpt",
    "load_smplx_npz",
    "skinning",
    "skinning_reference",
    "smplx_forward",
    "smplx_params_from_numpy",
    "synthetic_smplx_params",
    "vposer_decode",
    "vposer_encode",
    "vposer_params_from_numpy",
    "vposer_rsample",
]
