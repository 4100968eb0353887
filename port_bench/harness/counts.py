"""The benchmark's peaks and the arithmetic on them.

An architecture (``arch/<name>.py``) counts its model FLOPs and, per call
of each custom op it names, the operations and bytes from the inputs that
call was given: each input byte read once and each output byte written
once, and the multiply-adds the data needs. A kernel's least time is the
larger of its operations over the bf16 peak and its bytes over the HBM
rate.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The larger of the two bounds, and which it is."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mfu_pct(flops_per_image: float, img_s: float) -> float:
    return 100.0 * flops_per_image * img_s / PEAK_BF16
