"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit) and the byte counts of the port's kernels."""

from __future__ import annotations

from typing import Sequence

FLOPS_PER_S = {
    "bf16": 989e12,   # tensor cores, bfloat16 operands
    "tf32": 495e12,   # tensor cores, TF32 operands
    "f32": 67e12,     # float32 outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops_by_precision: dict) -> float:
    """The least time for these operations: each precision's FLOPs over
    its peak, summed."""
    return sum(f / FLOPS_PER_S[p] for p, f in flops_by_precision.items())


def jitter_normalize_bytes(shape: Sequence[int], element_bytes: int = 2) -> int:
    """Bytes kernel 1 (``jitter_normalize``) must move for one call on
    planar (N, 3, H, W) images: each image read once and written once in
    its dtype, and the (N, 8) float32 factor table read once. Bytes bound
    it: its operations, at most 9 + 6 + 3 * 70 float32 operations a pixel,
    take 0.0563 ms at the float32 peak for (1024, 3, 128, 128), under the
    0.0601 ms its bytes take."""
    n, c, h, w = shape
    return 2 * n * c * h * w * element_bytes + n * 8 * 4
