"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).

Every roofline and `mfu` divides the work that the inputs need by the peak
that no path faithful to the configuration's precision can beat: for fp32
operands the TF32 tensor-core rate (a kernel that kept fp32 accuracy with
fewer TF32 passes still cannot pass it), for bf16 operands the bf16 rate;
bytes at the HBM rate."""
from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(compute_dtype: str) -> float:
    return PEAK_FLOPS[compute_dtype]


def least_seconds(flops: float, nbytes: float, compute_dtype: str) -> float:
    """The least time of `flops` operations and `nbytes` bytes moved: the
    larger of the two at their peaks."""
    return max(flops / peak_flops(compute_dtype), nbytes / HBM_BYTES_PER_S)
