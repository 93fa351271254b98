"""Fused DrQ shift + colour jitter + normalize: a hand-written CUDA C++
kernel for Hopper, its plain version, and the fused train augmentation
that reaches it.

``shift_jitter_normalize`` replaces
``tacorl_tpu/ops/pallas_aug.py:_shift_jitter_kernel`` (launched by
``fused_shift_jitter_normalize``): per image, an integer shift
(dy, dx) = factors[:, 7:9] out of an edge-padded image, then the tail of
``jitter_normalize``, float32 in and out. The kernel source is
``tacorl_tpu_torch/csrc/shift_jitter.cu`` (with the shared
``csrc/jitter_common.cuh``), built by nvcc for sm_90a into ``build/cuda``
at its first launch (``ops/_cuda_build.py``).

What bounds it on the H100: bytes. The production entry reads
(1024, 3, 128, 128) float32 once and writes as much (201.3 MB each way)
and does a few dozen float32 operations per pixel. Design: each image is
split by bands of output rows over a thread-block cluster
(``shift_jitter_normalize_geometry``); a CTA copies its band's clamped
source rows into shared memory once, with 16-byte copies, and the contrast
slot's grayscale mean is a sum over the cluster, so the image is read from
device memory once. The shift is an address, and for an unpadded input the
edge padding is a clamp of it, so no padded copy is made.

``fused_augment_rgb_train`` is the counterpart of
``pallas_augment_rgb_train``: uint8 (..., H, W, 3) -> antialiased
bilinear resize -> the kernel -> float32 (..., h, w, 3) in [-1, 1].
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor

from tacorl_tpu_torch.ops import image_aug
from tacorl_tpu_torch.ops._cuda_build import load_library
from tacorl_tpu_torch.ops.jitter_aug import (
    CHUNK,
    CLUSTER_SIZES,
    MAX_SMEM_BYTES,
    MAX_THREADS,
    SCRATCH_BYTES,
    block_shape,
    pick_cluster,
    jitter_normalize_reference,
    raise_on_status,
    sample_jitter_factors,
)

__all__ = [
    "shift_jitter_normalize",
    "shift_jitter_normalize_reference",
    "shift_jitter_normalize_geometry",
    "fused_augment_rgb_train",
]

_N_FACTORS = 10


def shift_jitter_normalize_smem_bytes(band_rows: int, in_w: int) -> int:
    """Dynamic shared memory of one CTA: its band's source rows, 3 planes
    of float32 (csrc/shift_jitter.cu's function of the same name)."""
    return 3 * band_rows * in_w * 4


def shift_jitter_normalize_geometry(
    n: int, in_h: int, in_w: int, out_h: int, out_w: int
) -> Dict[str, int]:
    """Launch geometry of ``shift_jitter_normalize`` for n images of
    (in_h, in_w) in and (out_h, out_w) out: each image is one cluster of
    ``cluster`` CTAs, each CTA a band of ``band_rows`` output rows whose
    source rows it holds in ``smem_bytes`` of shared memory (dynamic plus
    the reduction scratch), ``threads`` threads of ``chunks_per_thread`` x 8
    pixels each; ``grid`` CTAs (``pick_cluster``, with bands that fit a
    CTA's shared memory). Raises ValueError for an image that 8 CTAs cannot
    hold."""

    def rows(c: int) -> int:
        return -(-out_h // c)

    def band_chunks(c: int) -> int:
        return -(-rows(c) * out_w // CHUNK)

    def smem(c: int) -> int:
        return shift_jitter_normalize_smem_bytes(rows(c), in_w)

    c = pick_cluster(n, band_chunks, lambda c: smem(c) + SCRATCH_BYTES <= MAX_SMEM_BYTES)
    if c is None:
        raise ValueError(
            f"an output image of {out_h}x{out_w} from {in_h}x{in_w} does not fit one "
            f"cluster of {CLUSTER_SIZES[-1]} CTAs (shared memory or registers)"
        )
    threads, k = block_shape(band_chunks(c))
    return {
        "cluster": c, "grid": n * c, "threads": threads, "chunks_per_thread": k,
        "band_rows": rows(c), "smem_bytes": smem(c) + SCRATCH_BYTES,
    }


def _shifted_indices(shifts: Tensor, size: int, in_size: int, off: int) -> Tensor:
    """(N, size) source rows (or columns): clamp(i + shift - off)."""
    i = torch.arange(size, device=shifts.device)
    return torch.clamp(i[None, :] + shifts[:, None] - off, 0, in_size - 1)


def _out_hw(images: Tensor, pad: int, padded: bool) -> Tuple[int, int]:
    h, w = images.shape[-2:]
    return (h - 2 * pad, w - 2 * pad) if padded else (h, w)


def shift_jitter_normalize_reference(
    images: Tensor, factors: Tensor, pad: int, padded: bool = True
) -> Tensor:
    """Plain PyTorch version of the kernel: gather each image's shifted
    rows and columns, then ``jitter_normalize_reference``. ``images`` is
    (N, 3, H+2p, W+2p) edge-padded, or with ``padded=False`` the unpadded
    (N, 3, H, W), where the clamped index is the padding. float32 out."""
    n, c, in_h, in_w = images.shape
    out_h, out_w = _out_hw(images, pad, padded)
    off = 0 if padded else pad
    f = factors.float()
    shifts = f[:, 7:9].to(torch.int64)  # truncation, as the TPU kernel casts
    rows = _shifted_indices(shifts[:, 0], out_h, in_h, off)  # (N, out_h)
    cols = _shifted_indices(shifts[:, 1], out_w, in_w, off)  # (N, out_w)
    x = images.float()
    x = torch.gather(x, 2, rows[:, None, :, None].expand(n, c, out_h, in_w))
    x = torch.gather(x, 3, cols[:, None, None, :].expand(n, c, out_h, out_w))
    return jitter_normalize_reference(x, f[:, :8])


def _check(images: Tensor, factors: Tensor, pad: int, padded: bool) -> Dict[str, int]:
    if images.dim() != 4 or images.shape[1] != 3:
        raise ValueError(f"planar (N, 3, H, W) images expected, got {tuple(images.shape)}")
    if images.dtype != torch.float32:
        raise TypeError(f"images must be float32, got {images.dtype}")
    if tuple(factors.shape) != (images.shape[0], _N_FACTORS) or factors.dtype != torch.float32:
        raise ValueError(
            f"factors must be ({images.shape[0]}, {_N_FACTORS}) float32, got "
            f"{tuple(factors.shape)} {factors.dtype}"
        )
    if factors.device != images.device:
        raise ValueError("images and factors must be on the same device")
    if not (images.is_contiguous() and factors.is_contiguous()):
        raise ValueError("images and factors must be contiguous")
    out_h, out_w = _out_hw(images, pad, padded)
    if pad < 0 or out_h <= 0 or out_w <= 0:
        raise ValueError(f"pad {pad} does not fit images of shape {tuple(images.shape)}")
    n, _, in_h, in_w = images.shape
    return shift_jitter_normalize_geometry(n, in_h, in_w, out_h, out_w)


def _library():
    lib = load_library("shift_jitter")
    fn = lib.shift_jitter_normalize_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def shift_jitter_normalize(
    images: Tensor, factors: Tensor, pad: int, padded: bool = True
) -> Tensor:
    """Counterpart of ``fused_shift_jitter_normalize``: float32 planar
    images in 0..255 and an (N, 10) float32 table [brightness, contrast,
    hue, op0, op1, op2, apply, dy, dx, pad] with dy, dx in [0, 2*pad] ->
    float32 (N, 3, H, W) in [-1, 1]. ``images`` is edge-padded
    (N, 3, H+2p, W+2p), or unpadded (N, 3, H, W) with ``padded=False``.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises (a failed build or launch is
    never replaced by the plain version)."""
    geo = _check(images, factors, pad, padded)
    if images.device.type == "cpu":
        return shift_jitter_normalize_reference(images, factors, pad, padded)
    lib = _library()
    n, _, in_h, in_w = images.shape
    out_h, out_w = _out_hw(images, pad, padded)
    out = torch.empty((n, 3, out_h, out_w), dtype=torch.float32, device=images.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.shift_jitter_normalize_launch(
        images.data_ptr(), factors.data_ptr(), out.data_ptr(), n, in_h, in_w,
        out_h, out_w, 0 if padded else pad, geo["cluster"], geo["threads"],
        geo["chunks_per_thread"], geo["band_rows"], stream,
    )
    raise_on_status("shift_jitter_normalize", status)
    shift_jitter_normalize.launches += 1
    return out


shift_jitter_normalize.launches = 0


def fused_augment_rgb_train(
    images: Tensor,
    out_hw: Sequence[int] = (128, 128),
    pad: int = 6,
    brightness: float = 0.1,
    contrast: float = 0.1,
    hue: float = 0.02,
    prob: float = 1.0,
    *,
    shifts: Optional[Tensor] = None,
    factors: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Counterpart of ``pallas_augment_rgb_train``: uint8 (..., H, W, 3)
    -> float32 planar -> ``jax.image.resize`` bilinear (antialiased) to
    ``out_hw`` -> DrQ shift with edge padding ``pad`` + colour jitter +
    normalize in one kernel -> float32 (..., h, w, 3) in [-1, 1], JAX's
    layout. ``shifts`` (N, 2) in [0, 2*pad] and ``factors`` (N, 8) (the
    table of ``sample_jitter_factors``) are drawn from ``generator`` when
    not given, with the distributions the JAX function draws from."""
    lead = images.shape[:-3]
    flat = images.reshape((-1,) + tuple(images.shape[-3:]))
    n = flat.shape[0]
    if generator is None and (shifts is None or factors is None):
        raise ValueError("pass shifts and factors, or a generator to draw them from")
    planar = image_aug.resize_antialias(flat.permute(0, 3, 1, 2), out_hw)
    dev = planar.device
    if shifts is None:
        shifts = torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=dev)
    if factors is None:
        factors = sample_jitter_factors(n, generator, brightness, contrast, hue, prob)
    table = torch.cat(
        [
            factors.to(dev, torch.float32)[:, :7],
            shifts.to(dev, torch.float32),
            torch.zeros((n, 1), device=dev),
        ],
        dim=-1,
    )
    out = shift_jitter_normalize(planar.contiguous(), table.contiguous(), pad, padded=False)
    return out.permute(0, 2, 3, 1).reshape(tuple(lead) + (out.shape[2], out.shape[3], 3))
