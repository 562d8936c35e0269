"""Fused LBS skinning: the CUDA kernel ``csrc/lbs_skinning.cu`` and its
plain PyTorch version.

Counterpart of airpose_tpu/bodymodel/pallas_lbs.py (``skinning_pallas``).
For each body b and vertex v the kernel forms T = Σ_j W[v, j]·A[b, j] and
returns T[:3, :3]·p + T[:3, 3] without writing the (B, V, 16) T to memory.
On an H100 the work is bound by f32 FMAs on the CUDA cores; the source
explains the tiling. ``skinning`` takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
"""

import ctypes

import torch

from ..ops import _build

launches = 0  # kernel launches since the last reset (a plain integer)
MAX_JOINTS = 256


def skinning_reference(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
                       v_posed: torch.Tensor) -> torch.Tensor:
    """The two-einsum formulation of bodymodel/lbs.py: (V, J), (B, J, 4, 4),
    (B, V, 3) → (B, V, 3)."""
    B = rel_tf.shape[0]
    T = torch.einsum(
        "vj,bjk->bvk", lbs_weights, rel_tf.reshape(B, -1, 16)
    ).reshape(B, -1, 4, 4)
    return torch.einsum("bvij,bvj->bvi", T[..., :3, :3], v_posed) + T[..., :3, 3]


def skinning(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
             v_posed: torch.Tensor) -> torch.Tensor:
    """Skinned vertices (B, V, 3): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if v_posed.device.type == "cpu":
        return skinning_reference(lbs_weights, rel_tf, v_posed)
    return skinning_cuda(lbs_weights, rel_tf, v_posed)


def skinning_cuda(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
                  v_posed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take."""
    global launches
    V, J = lbs_weights.shape
    B = rel_tf.shape[0]
    if not 0 < J <= MAX_JOINTS:
        raise ValueError(f"skinning_cuda: {J} joints, the kernel takes 1..{MAX_JOINTS}")
    if torch.is_grad_enabled() and (lbs_weights.requires_grad
                                    or rel_tf.requires_grad
                                    or v_posed.requires_grad):
        raise RuntimeError("skinning_cuda has no backward yet")
    for name, t, shape in (("lbs_weights", lbs_weights, (V, J)),
                           ("rel_tf", rel_tf, (B, J, 4, 4)),
                           ("v_posed", v_posed, (B, V, 3))):
        if t.device.type != "cuda" or t.device != v_posed.device:
            raise ValueError(f"skinning_cuda: {name} is on {t.device}, "
                             "all inputs must be on one CUDA device")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"skinning_cuda: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {shape}")
        if not t.is_contiguous():
            raise ValueError(f"skinning_cuda: {name} is not contiguous")
    # the transforms are copied in 16-byte pieces; W is read by 4-byte copies
    # and p through the 16-byte-aligned span around it, so both may start at
    # any float
    if rel_tf.data_ptr() % 16:
        raise ValueError("skinning_cuda: rel_tf is not 16-byte aligned")
    out = torch.empty_like(v_posed)
    if B and V:
        fn = _build.function("lbs_skinning", "airpose_lbs_skinning", 4, 3)
        args = (lbs_weights.data_ptr(), rel_tf.data_ptr(), v_posed.data_ptr(),
                out.data_ptr(), B, V, J)
        dev = v_posed.device.index
        if dev == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        _build.check(err, "lbs_skinning")
        launches += 1
    return out


def kernel_resources(joints: int = 55) -> dict:
    """For ``joints`` joints on the current CUDA device: the kernel's
    registers a thread, dynamic shared memory a block and resident blocks an
    SM."""
    fn = _build.function("lbs_skinning", "airpose_lbs_skinning_resources", 3, 1,
                         stream=False)
    vals = [ctypes.c_int() for _ in range(3)]
    _build.check(fn(*(ctypes.addressof(v) for v in vals), joints), "lbs_skinning resources")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"), (v.value for v in vals)))
