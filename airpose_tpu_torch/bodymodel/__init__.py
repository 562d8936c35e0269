from .cuda_lbs import skinning, skinning_reference
from .smpl import SMPLOutput, SMPLParams, smpl_forward, synthetic_smpl_params
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
    "SMPLOutput",
    "SMPLParams",
    "SMPLXOutput",
    "SMPLXParams",
    "VPoserParams",
    "convert_torch_state_dict",
    "init_vposer_params",
    "load_vposer_ckpt",
    "load_smplx_npz",
    "skinning",
    "skinning_reference",
    "smpl_forward",
    "smplx_forward",
    "smplx_params_from_numpy",
    "synthetic_smpl_params",
    "synthetic_smplx_params",
    "vposer_decode",
    "vposer_encode",
    "vposer_params_from_numpy",
    "vposer_rsample",
]
