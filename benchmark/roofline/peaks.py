"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

INT8_OPS = 1979e12      # int8 tensor cores, operations per second
BF16_FLOPS = 989e12     # bf16 tensor cores
FP32_FLOPS = 67e12      # float32 outside the tensor cores (TF32 off)
HBM_BYTES = 3.35e12     # HBM3, bytes per second

PEAK = {"int8": INT8_OPS, "bf16": BF16_FLOPS, "fp32": FP32_FLOPS}


def least_seconds(ops_by_precision, n_bytes: float = 0.0) -> float:
    """The least time the chip could take: each precision's operations at
    its peak, one after another, or the bytes at the bandwidth, whichever
    is longer."""
    compute = sum(ops / PEAK[p] for p, ops in ops_by_precision.items())
    return max(compute, n_bytes / HBM_BYTES)
