"""airpose_tpu_torch — the PyTorch/CUDA port of airpose_tpu for one NVIDIA H100.

The JAX package ``airpose_tpu`` beside it is the reference: module and file
names here mirror it, public functions keep its layouts (images
(B, 2, H, W, 3) NHWC, ``bb`` (B, 2, 3), ``intr`` (B, 2, 3, 3), pose
(B, 2, 135), betas (B, 2, 10)), and the tests hold each function of this
package against its JAX counterpart. This package imports neither JAX nor
anything of ``airpose_tpu``.

Layer map of the ported slices (the two-view perception chain with its bf16,
int8 and int8-block trunks, the synthetic training steps of every model
family, the trainer CLI with its readers, the real-data self-supervised
fine-tune, the eval CLI and AirPose+, two-drone serving, and the reference
workflow's tools):
  tools/         the fixture generators, the dress rehearsal that chains every
                 CLI, the training-step roofline, the QAT posture experiment,
                 calibration, real-capture preparation, the HDF5 export
  utils/         profiling (span, trace, sync) and the mesh renderer
  serve/         the 145-float wire (protocol.py), the staged 3-step regressor
                 (staged.py), the per-drone TCP server, the served-vs-offline
                 benchtest, the lag-one report and the result viz
  perception.py  the chain of the root bench.py: trunk → IEF → 6D → SMPL-X → projection
  entry.py       entry points: the flagship forward and the multi-device dry run
  train/         the training steps: loop.py (make_twoview_step_fns,
                 make_singleview_step_fns, the real-data make_real_*_step_fns),
                 state.py (TrainState, optax-equal AMSGrad), losses.py,
                 trainer.py (the CLI); flax → torch weight carry of every family
  eval/          MPJPE, PA-MPJPE, MPE (metrics.py), the eval CLI
                 (compile_results.py), the figures
  optim/         AirPose+, the per-sequence bundle adjustment
  data/          synthetic two-view dataset, the input pipeline, the
                 readers (AerialPeople, H36M, TotalCapture, mixed, DJI, AirCap),
                 joint tables
  config.py      TrainConfig and the loss weights
  models/        ResNet-50 trunk (eval and train-mode BatchNorm), IEF regressor,
                 HMR, SingleViewFullCam, MuHMR, AirPoseTwoView, AirPoseTwoViewSep
  ops/           fused layer1 stage, int8 stem, conv and blocks, the ViT's
                 residual add + LayerNorm (CUDA kernels), QAT, the nvcc/ctypes
                 builder and the one launch path of every kernel (_build.py)
  bodymodel/     SMPL-X forward, LBS, skinning (CUDA kernel, with its backward),
                 the VPoser pose prior
  geometry/      rotation conversions, projections and rigid transforms, robustifiers
  csrc/          the CUDA C++ kernel sources (sm_90a)

Entry points run on the GPU: ``device=None`` means ``"cuda"``, and without a
CUDA device they raise. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the CPU, as the tests do.
"""

import functools

import torch

# The JAX side runs geometry and SMPL-X at precision="highest"; TF32 would
# keep only ~3 decimal digits in f32 matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA device. Raises when CUDA is asked for (explicitly
    or by default) and none is available: nothing falls back to the CPU
    unless the caller asks for ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "airpose_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` made once per
    (values, dtype, device) and shared from then on: a number or a (nested)
    tuple of numbers, e.g. an index table or a fixed row. A train step
    replayed as a CUDA graph may copy nothing from the host, so its
    constants are made at its first, eager call. Callers must not write to
    the tensor."""
    return _constant(values, dtype, torch.device(device))
