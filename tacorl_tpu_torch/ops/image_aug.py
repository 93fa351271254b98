"""Image preprocessing ops (port of tacorl_tpu/ops/image_aug.py).

Layout: the port keeps images PLANAR, (N, 3, H, W), from the uint8 input
onward, because the encoder consumes NCHW; the JAX package works on
(N, H, W, 3) and transposes to planar only for its Pallas kernel. The
resize and the DrQ shift are GEMMs (XLA computes them outside any Pallas
kernel), so ``torch.einsum`` is their counterpart here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

__all__ = [
    "resize_bilinear",
    "antialias_resize_matrix",
    "resize_antialias",
    "resize_shift",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "adjust_brightness",
    "adjust_contrast",
    "adjust_hue",
    "grayscale",
    "normalize",
    "augment_rgb_eval",
]


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix with torchvision tensor-mode
    Resize semantics: align_corners=False, no antialias (each output pixel
    is a 2-tap blend even when downscaling)."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src)
    w1 = src - i0
    i0c = np.clip(i0, 0, in_size - 1).astype(np.int64)
    i1c = np.clip(i0 + 1, 0, in_size - 1).astype(np.int64)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(m, (np.arange(out_size), i0c), (1.0 - w1).astype(np.float32))
    np.add.at(m, (np.arange(out_size), i1c), w1.astype(np.float32))
    return m


def _interp(in_size: int, out_size: int, like: Tensor, dtype) -> Tensor:
    return torch.as_tensor(
        _interp_matrix(in_size, out_size), device=like.device
    ).to(dtype)


def resize_bilinear(
    images: Tensor, out_hw: Sequence[int], dtype: torch.dtype = torch.float32
) -> Tensor:
    """Bilinear resize of planar (..., C, H, W) images, torchvision
    tensor-mode semantics; two constant-matrix products (rows, then
    columns) as in the JAX package."""
    *lead, c, h, w = images.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return images.to(dtype)
    x = images.reshape(-1, c, h, w).to(dtype)
    ry = _interp(h, oh, x, dtype)
    rx = _interp(w, ow, x, dtype)
    t = torch.einsum("yh,nchw->ncyw", ry, x)
    out = torch.einsum("xw,ncyw->ncyx", rx, t)
    return out.reshape(*lead, c, oh, ow)


def antialias_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis, whose ``antialias=True`` default widens the triangle
    kernel by 1/scale on a downscale (``compute_weight_mat`` of
    ``jax/_src/image/scale.py``, in float32 as JAX computes it): each
    column normalized to sum 1, and zero where the sample lies outside
    [-0.5, in - 0.5]. Not torchvision's or PIL's antialias, whose edges
    differ."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32).T


def resize_antialias(images: Tensor, out_hw: Sequence[int]) -> Tensor:
    """``jax.image.resize(images, ..., "bilinear")`` (antialiased on a
    downscale) of planar float (..., C, H, W) images: two float32 matrix
    products, rows then columns."""
    *_, h, w = images.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    x = images.float()
    if (h, w) == (oh, ow):
        return x
    ry = torch.as_tensor(antialias_resize_matrix(h, oh), device=x.device)
    rx = torch.as_tensor(antialias_resize_matrix(w, ow), device=x.device)
    return torch.matmul(torch.matmul(ry, x), rx.T)


def resize_shift(
    images: Tensor,
    shifts: Tensor,
    out_hw: Sequence[int],
    pad: int,
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Resize followed by the DrQ integer shift, planar (N, C, H, W).

    ``shifts`` (N, 2) holds (dy, dx) in [0, 2*pad], the draw the JAX
    package makes with ``jax.random.randint(key, (n, 2), 0, 2 * pad + 1)``.
    Edge replication is the clamped source index
    clamp(y + dy - pad, 0, H-1); the shifted interpolation matrices are the
    constant matrices' rows at those indices (the JAX package composes
    one-hot matrices with them, which copies the same rows). The images
    then take two passes, rows first, then columns."""
    n, c, h, w = images.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    x = images.to(dtype)
    ry = _interp(h, oh, x, dtype)  # (oh, h)
    rx = _interp(w, ow, x, dtype)  # (ow, w)
    shifts = shifts.to(device=x.device, dtype=torch.long)
    rows_out = torch.arange(oh, device=x.device)
    cols_out = torch.arange(ow, device=x.device)
    src_y = torch.clamp(rows_out[None, :] + shifts[:, :1] - pad, 0, oh - 1)
    src_x = torch.clamp(cols_out[None, :] + shifts[:, 1:] - pad, 0, ow - 1)
    cy = ry[src_y]  # (n, oh, h)
    cx = rx[src_x]  # (n, ow, w)
    out = torch.einsum("nyh,nchw->ncyw", cy, x)
    return torch.einsum("nxw,ncyw->ncyx", cx, out)


# ---------------------------------------------------------------------------
# Colour ops, planar: the channel axis is -3 (torchvision-equivalent math)
# ---------------------------------------------------------------------------


def rgb_to_hsv(rgb: Tensor) -> Tensor:
    """(..., 3, H, W) float in [0, 1] -> HSV (..., 3, H, W) in [0, 1]."""
    r, g, b = rgb.unbind(-3)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta > 0, delta, 1.0)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    # tie order: maxc == r first, then maxc == g
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(delta > 0, h, 0.0)
    # floor-mod (result has the divisor's sign, like jnp's %); fmod is wrong
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-3)


def hsv_to_rgb(hsv: Tensor) -> Tensor:
    h, s, v = hsv.unbind(-3)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # integer mod: h * 6 can round to 6.0
    i = torch.remainder(i.to(torch.int32), 6)
    r = torch.where(
        (i == 0) | (i == 5), v, torch.where(i == 1, q, torch.where(i == 4, t, p))
    )
    g = torch.where(
        (i == 1) | (i == 2), v, torch.where(i == 0, t, torch.where(i == 3, q, p))
    )
    b = torch.where(
        (i == 3) | (i == 4), v, torch.where(i == 2, t, torch.where(i == 5, q, p))
    )
    return torch.stack([r, g, b], dim=-3)


def grayscale(rgb: Tensor) -> Tensor:
    """ITU-R 601 luma used by torchvision rgb_to_grayscale; (..., 3, H, W)
    -> (..., H, W)."""
    return 0.2989 * rgb[..., 0, :, :] + 0.587 * rgb[..., 1, :, :] + 0.114 * rgb[..., 2, :, :]


def adjust_brightness(img: Tensor, factor: Tensor) -> Tensor:
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img: Tensor, factor: Tensor) -> Tensor:
    """Per-image contrast around the mean of its grayscale image."""
    mean = grayscale(img).mean(dim=(-2, -1), keepdim=True)[..., None, :, :]
    return torch.clamp(factor * img + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_hue(img: Tensor, offset: Tensor) -> Tensor:
    """``offset`` broadcasts against (..., 1, H, W)."""
    h, s, v = rgb_to_hsv(img).unbind(-3)
    h = torch.remainder(h + offset[..., 0, :, :], 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-3))


def normalize(images: Tensor, mean: float = 0.5, std: float = 0.5) -> Tensor:
    return (images - mean) / std


def augment_rgb_eval(images: Tensor, out_hw: Tuple[int, int] = (128, 128)) -> Tensor:
    """Validation pipeline on planar (..., 3, H, W) uint8 images:
    resize -> scale -> normalize, float32."""
    x = resize_bilinear(images, out_hw)
    x = torch.clamp(x / 255.0, 0.0, 1.0)
    return normalize(x)
