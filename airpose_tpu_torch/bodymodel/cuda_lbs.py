"""Fused LBS skinning: the CUDA kernel ``csrc/lbs_skinning.cu`` and its
plain PyTorch version.

Counterpart of airpose_tpu/bodymodel/pallas_lbs.py (``skinning_pallas``).
For each body b and vertex v the kernel forms T = Σ_j W[v, j]·A[b, j] and
returns T[:3, :3]·p + T[:3, 3] without writing the (B, V, 16) T to memory.
On an H100 the work is bound by f32 FMAs on the CUDA cores; the source
explains the tiling. ``skinning`` takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises.

The gradient: ``skinning_cuda`` is a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is ``skinning_backward``, plain
torch ops (two cuBLAS products and an elementwise pass; the JAX package has
no backward kernel either, XLA differentiates its einsum pair). Only the
transforms A and the posed vertices p take a gradient; the skinning weights
W are model constants and asking for their gradient raises.
"""

import ctypes

import torch

from ..ops import _build

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


def skinning_backward(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
                      v_posed: torch.Tensor, grad: torch.Tensor):
    """Gradients (d rel_tf (B, J, 4, 4), d v_posed (B, V, 3)) of the skinned
    vertices for the output gradient ``grad`` (B, V, 3), from W, A and p
    alone (T = Σ_j W[v, j]·A[b, j] is recomputed, never stored):

      dp[b, v]           = T[b, v, :3, :3]ᵀ · g[b, v]
      dA[b, j, :3, :]    = Σ_v W[v, j] · g[b, v] ⊗ [p[b, v]; 1]   (row 3 is 0)

    Both sums over joints and vertices are (V, J) × (J, B·k) products;
    the intermediates stay vertex-major, (V, B, ·), so that neither product
    needs a transposed copy."""
    B, V = v_posed.shape[:2]
    J = lbs_weights.shape[1]
    g = grad.transpose(0, 1)  # (V, B, 3) views
    p = v_posed.transpose(0, 1)
    rot = rel_tf[:, :, :3, :3].permute(1, 0, 2, 3).reshape(J, B * 9)
    T = torch.matmul(lbs_weights, rot).view(V, B, 3, 3)
    d_p = (T * g[..., None]).sum(dim=2).transpose(0, 1)
    outer = torch.empty(V, B, 3, 4, dtype=grad.dtype, device=grad.device)
    torch.mul(g[..., None], p[..., None, :], out=outer[..., :3])
    outer[..., 3] = g
    d_a3 = torch.matmul(lbs_weights.t(), outer.view(V, B * 12)).view(J, B, 3, 4)
    d_a = rel_tf.new_zeros(B, J, 4, 4)
    d_a[:, :, :3] = d_a3.transpose(0, 1)
    return d_a, d_p


class _Skinning(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lbs_weights, rel_tf, v_posed):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("skinning: lbs_weights takes no gradient "
                               "(the skinning weights are model constants)")
        out = _launch(lbs_weights, rel_tf, v_posed)
        ctx.save_for_backward(lbs_weights, rel_tf, v_posed)
        return out

    @staticmethod
    def backward(ctx, grad):
        d_a, d_p = skinning_backward(*ctx.saved_tensors, grad)
        return (None, d_a if ctx.needs_input_grad[1] else None,
                d_p if ctx.needs_input_grad[2] else None)


def skinning_cuda(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
                  v_posed: torch.Tensor) -> torch.Tensor:
    """The kernel, differentiable in ``rel_tf`` and ``v_posed``; raises on
    anything the kernel does not take."""
    return _Skinning.apply(lbs_weights, rel_tf, v_posed)


def _launch(lbs_weights: torch.Tensor, rel_tf: torch.Tensor,
            v_posed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take."""
    V, J = lbs_weights.shape
    B = rel_tf.shape[0]
    if not 0 < J <= MAX_JOINTS:
        raise ValueError(f"skinning_cuda: {J} joints, the kernel takes 1..{MAX_JOINTS}")
    dev = v_posed.device
    if dev.type != "cuda":
        raise ValueError(f"skinning_cuda: v_posed is on {dev}, not CUDA")
    # the transforms are copied in 16-byte pieces; W is read by 4-byte copies
    # and p through the 16-byte-aligned span around it, so both may start at
    # any float
    for name, t, shape, align in (("lbs_weights", lbs_weights, (V, J), 0),
                                  ("rel_tf", rel_tf, (B, J, 4, 4), 16),
                                  ("v_posed", v_posed, (B, V, 3), 0)):
        _build.check_tensor("skinning_cuda", name, t, dev, torch.float32, shape, align)
    out = torch.empty_like(v_posed)
    if B and V:
        fn = _build.function("lbs_skinning", "airpose_lbs_skinning", 4, 3)
        _build.launch(fn, (lbs_weights.data_ptr(), rel_tf.data_ptr(), v_posed.data_ptr(),
                           out.data_ptr(), B, V, J), dev, "lbs_skinning")
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
