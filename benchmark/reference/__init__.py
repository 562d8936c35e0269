"""The plain reference that decides ``correct``.

Plain PyTorch of the same mathematics as the system under test: the
ResNet-50 trunk (bf16 convolutions with f32 BatchNorm, or the int8
post-training-quantized trunk with its calibration), the IEF regressors of
AirPose and HMR, SMPL-X with its skinning as an einsum pair, the losses and
AMSGrad. It is written from the published models and the port's documented
numerics, and imports neither ``jax`` nor ``airpose_tpu`` nor anything of
``airpose_tpu_torch``: the benchmark hands it the raw weights and inputs it
made from the seed, and it derives again whatever the program derives from
them (folded BatchNorm, quantized weights, activation scales, optimizer
state). ``benchmark/imports.py`` checks that this stays so.
"""
