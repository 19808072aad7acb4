"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the least time a
kernel's work can take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
INT8_TC_OPS = 1979e12
FP32_FLOPS = 67e12


def bound_s(n_bytes: float, tc_ops: float, fp32_ops: float,
            tc_peak: float = BF16_TC_FLOPS) -> float:
    """The larger of the bytes over HBM's rate and the operations over the
    peak rate of their type (``tc_peak``: the tensor cores' bf16 or int8)."""
    return max(n_bytes / HBM_BYTES_PER_S, tc_ops / tc_peak, fp32_ops / FP32_FLOPS)
