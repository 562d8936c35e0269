"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' input checks. Imports neither JAX nor airpose_tpu, so that on a
machine with a card (where JAX need not be installed) the tests run with

  python -m pytest tests/test_torch_kernels.py --noconftest -q

The tests marked ``cuda`` skip where no CUDA device is present."""

import numpy as np
import pytest
import torch

from airpose_tpu_torch.bodymodel import cuda_lbs
from airpose_tpu_torch.models.resnet import ResNet50
from airpose_tpu_torch.ops import fused_bottleneck as fb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stage_ops():
    """Folded layer1 operands of a seeded trunk with BN statistics moved off
    (0, 1), on the CPU."""
    rng = np.random.default_rng(0)
    sd = ResNet50(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in sd:
        if k.startswith("layer1.") and k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.startswith("layer1.") and k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    return fb.stage1_params_from_state_dict(sd)


def _skin_inputs(V, B, J, device, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    a = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    a[:, :, 3] = [0, 0, 0, 1]
    p = rng.normal(size=(B, V, 3)).astype(np.float32)
    return tuple(torch.from_numpy(t).to(device) for t in (w, a, p))


def test_skinning_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lbs.skinning_cuda(*_skin_inputs(8, 1, 2, "cpu"))


def test_fused_stage1_cuda_rejects_cpu_tensors(stage_ops):
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_stage1_cuda(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16), stage_ops)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,J", [(10475, 128, 55), (1000, 9, 55), (77, 3, 24)])
def test_skinning_kernel_matches_reference(cuda, V, B, J):
    w, a, p = _skin_inputs(V, B, J, cuda)
    n = cuda_lbs.launches
    got = cuda_lbs.skinning(w, a, p)
    assert cuda_lbs.launches == n + 1
    torch.testing.assert_close(got, cuda_lbs.skinning_reference(w, a, p),
                               atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_skinning_kernel_rejects_bad_inputs(cuda):
    w, a, p = _skin_inputs(100, 2, 55, cuda)
    with pytest.raises(ValueError, match="float32"):
        cuda_lbs.skinning(w.double(), a, p)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lbs.skinning(w, a, p.transpose(0, 1).contiguous().transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w", [(4, 56, 56), (3, 9, 13)])
def test_fused_stage1_kernel_matches_reference(cuda, stage_ops, B, h, w):
    ops = [{k: v.to(cuda) for k, v in blk.items()} for blk in stage_ops]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.abs(rng.normal(size=(B, h, w, 64))).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    n = fb.launches
    got = fb.fused_stage1(x, ops)
    assert fb.launches == n + 3
    torch.testing.assert_close(got.float(), fb.fused_stage1_reference(x, ops).float(),
                               atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_fused_stage1_kernel_rejects_bad_inputs(cuda, stage_ops):
    ops = [{k: v.to(cuda) for k, v in blk.items()} for blk in stage_ops]
    with pytest.raises(ValueError, match="bfloat16"):
        fb.fused_stage1(torch.zeros(1, 8, 8, 64, device=cuda), ops)
    with pytest.raises(ValueError, match="width"):
        fb.fused_stage1(torch.zeros(1, 8, 200, 64, device=cuda, dtype=torch.bfloat16), ops)
