from .aerialpeople import AerialPeopleDataset
from .aircap import AircapDataset
from .h36m import H36MDataset
from .joints import SMPLX_TO_H36M17
from .mixed import MixedDataset
from .pipeline import (
    Prefetcher,
    bb_encoding,
    crop_resize_pad,
    finish_batch,
    jitter_crop_boxes,
)
from .real import CopenetRealDataset
from .synthetic import batch_slice, make_synthetic_dataset
from .totalcap import TotalCaptureDataset

__all__ = [
    "AerialPeopleDataset",
    "AircapDataset",
    "CopenetRealDataset",
    "H36MDataset",
    "MixedDataset",
    "Prefetcher",
    "SMPLX_TO_H36M17",
    "TotalCaptureDataset",
    "batch_slice",
    "bb_encoding",
    "crop_resize_pad",
    "finish_batch",
    "jitter_crop_boxes",
    "make_synthetic_dataset",
]
