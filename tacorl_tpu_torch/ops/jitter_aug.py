"""Fused colour-jitter + normalize: a hand-written Triton kernel for Hopper.

Replaces ``tacorl_tpu/ops/pallas_aug.py:_jitter_kernel`` (launched by
``fused_jitter_normalize``). Per image of a planar (N, 3, H, W) batch in
0..255, f32 or bf16 IO, f32 math:

    x = clip(img / 255, 0, 1)
    y = three op slots in the image's order (factors[3:6]):
        0 brightness clip(x * b), 1 contrast clip(c * x + (1 - c) * mean(gray)),
        2 hue (RGB -> HSV, h + delta mod 1, -> RGB)
    out = (where(factors[6] > 0.5, y, x) - 0.5) / 0.5, in the input dtype

with the same (N, 8) factor table [brightness, contrast, hue, op0, op1,
op2, apply, pad] as the TPU kernel.

What bounds it on the H100: bytes. It reads and writes N*3*H*W elements
once each (production: 1024 x 3 x 128 x 128 bf16, 100.7 MB each way) and
does a few dozen f32 operations per pixel, far below the card's compute.
Design: one program per image, a loop over pixel tiles inside it.
Sweep 1 computes the image up to its contrast slot and reduces the
grayscale to its mean (exactly one slot is contrast, so one reduction
suffices); sweep 2 recomputes the whole chain with that mean and stores.
Sweep 1 is a second read of the image (the batch exceeds the 50 MB L2),
skipped for images whose jitter is off. The TPU kernel instead held the
whole image in VMEM for one read; a Hopper block has no room for that.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch
from torch import Tensor

from tacorl_tpu_torch.ops.image_aug import (
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    normalize,
)

__all__ = [
    "jitter_normalize",
    "jitter_normalize_reference",
    "sample_jitter_factors",
    "PERM_TABLE",
]

# permutation code -> per-slot op ids (0=brightness, 1=contrast, 2=hue)
PERM_TABLE = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

_BLOCK = 1024
_NUM_WARPS = 8
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "triton"
_KERNEL = None
tl = None  # triton.language, bound by _build_kernel


def sample_jitter_factors(
    n: int,
    generator: torch.Generator,
    brightness: float = 0.1,
    contrast: float = 0.1,
    hue: float = 0.02,
    prob: float = 1.0,
) -> Tensor:
    """(n, 8) float32 factor table on ``generator``'s device, with the
    ranges of the JAX sampler: brightness and contrast factors
    ~ U[max(0, 1-v), 1+v], hue offset ~ U[-h, h], the op order a uniform
    row of ``PERM_TABLE``, and apply = U[0, 1) < prob."""
    dev = generator.device

    def uniform(lo: float, hi: float) -> Tensor:
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    bf = uniform(max(0.0, 1.0 - brightness), 1.0 + brightness)
    cf = uniform(max(0.0, 1.0 - contrast), 1.0 + contrast)
    hf = uniform(-hue, hue)
    code = torch.randint(0, len(PERM_TABLE), (n,), generator=generator, device=dev)
    ops = torch.tensor(PERM_TABLE, dtype=torch.float32, device=dev)[code]
    apply = (torch.rand(n, generator=generator, device=dev) < prob).float()
    return torch.cat(
        [
            torch.stack([bf, cf, hf], dim=-1),
            ops,
            apply[:, None],
            torch.zeros((n, 1), device=dev),
        ],
        dim=-1,
    )


def jitter_normalize_reference(images: Tensor, factors: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel, batched: every slot computes
    all three ops and selects per image by its op code (a where-chain, as
    the TPU kernel does). Returns bf16 for bf16 input, else float32."""
    out_dtype = torch.bfloat16 if images.dtype == torch.bfloat16 else torch.float32
    x = torch.clamp(images.float() * (1.0 / 255.0), 0.0, 1.0)
    f = factors.float()
    bf, cf, hf = (f[:, k].view(-1, 1, 1, 1) for k in range(3))
    y = x
    for slot in range(3):
        op = f[:, 3 + slot].to(torch.int32).view(-1, 1, 1, 1)
        y = torch.where(
            op == 0,
            adjust_brightness(y, bf),
            torch.where(op == 1, adjust_contrast(y, cf), adjust_hue(y, hf)),
        )
    result = torch.where((f[:, 6] > 0.5).view(-1, 1, 1, 1), y, x)
    return normalize(result).to(out_dtype)


def _check(images: Tensor, factors: Tensor) -> None:
    if images.dim() != 4 or images.shape[1] != 3:
        raise ValueError(f"planar (N, 3, H, W) images expected, got {tuple(images.shape)}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"images must be float32 or bfloat16, got {images.dtype}")
    if tuple(factors.shape) != (images.shape[0], 8) or factors.dtype != torch.float32:
        raise ValueError(
            f"factors must be ({images.shape[0]}, 8) float32, got "
            f"{tuple(factors.shape)} {factors.dtype}"
        )
    if factors.device != images.device:
        raise ValueError("images and factors must be on the same device")
    if not (images.is_contiguous() and factors.is_contiguous()):
        raise ValueError("images and factors must be contiguous")


def jitter_normalize(images: Tensor, factors: Tensor) -> Tensor:
    """Counterpart of ``fused_jitter_normalize``: (N, 3, H, W) float32 or
    bfloat16 in 0..255 and an (N, 8) float32 factor table -> normalized
    images in [-1, 1], input dtype. Each image's op row must hold exactly
    one contrast op (``sample_jitter_factors`` guarantees it).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    Triton kernel on the current stream (or raises)."""
    _check(images, factors)
    if images.device.type == "cpu":
        return jitter_normalize_reference(images, factors)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    kernel = _build_kernel()
    out = torch.empty_like(images)
    n, _, h, w = images.shape
    with torch.cuda.device(images.device):
        kernel[(n,)](images, factors, out, h * w, BLOCK=_BLOCK, num_warps=_NUM_WARPS)
    jitter_normalize.launches += 1
    return out


jitter_normalize.launches = 0


# ---------------------------------------------------------------------------
# Triton kernel. The functions below are plain Python until ``_build_kernel``
# imports Triton (never at module import: the CPU tests import this module)
# and rebinds them as ``triton.jit`` functions in this module's namespace,
# where the kernel looks its callees up.
# ---------------------------------------------------------------------------


def _hue_shift(r, g, b, hf):
    """RGB -> HSV, h + hf (floor-mod 1), HSV -> RGB; ties and guards as in
    the TPU kernel's ``_rgb_to_hsv_kernel`` / ``_hsv_to_rgb_kernel``."""
    maxc = tl.maximum(tl.maximum(r, g), b)
    minc = tl.minimum(tl.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = tl.where(delta > 0, delta, 1.0)
    s = tl.where(maxc > 0, delta / tl.where(maxc > 0, maxc, 1.0), 0.0)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = tl.where(maxc == r, bc - gc, tl.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = tl.where(delta > 0, h, 0.0)
    # jnp's float % is a floor-mod (divisor's sign); h can be negative
    h = h / 6.0
    h = h - tl.floor(h)
    h = h + hf
    h = h - tl.floor(h)
    fi = tl.floor(h * 6.0)
    f = h * 6.0 - fi
    v = maxc
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # integer mod: h * 6 can round to 6.0
    i = fi.to(tl.int32) % 6
    r = tl.where((i == 0) | (i == 5), v, tl.where(i == 1, q, tl.where(i == 4, t, p)))
    g = tl.where((i == 1) | (i == 2), v, tl.where(i == 0, t, tl.where(i == 3, q, p)))
    b = tl.where((i == 3) | (i == 4), v, tl.where(i == 2, t, tl.where(i == 5, q, p)))
    return r, g, b


def _apply_op(r, g, b, op, bf, cf, hf, mean):
    """One op slot; ``op`` is uniform across the program, so the branch
    does not diverge."""
    if op == 0:
        r = tl.minimum(tl.maximum(r * bf, 0.0), 1.0)
        g = tl.minimum(tl.maximum(g * bf, 0.0), 1.0)
        b = tl.minimum(tl.maximum(b * bf, 0.0), 1.0)
    elif op == 1:
        shift = (1.0 - cf) * mean
        r = tl.minimum(tl.maximum(cf * r + shift, 0.0), 1.0)
        g = tl.minimum(tl.maximum(cf * g + shift, 0.0), 1.0)
        b = tl.minimum(tl.maximum(cf * b + shift, 0.0), 1.0)
    else:
        r, g, b = _hue_shift(r, g, b, hf)
    return r, g, b


def _load_scaled(ptr, offs, mask, HW):
    r = tl.load(ptr + offs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(ptr + HW + offs, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(ptr + 2 * HW + offs, mask=mask, other=0.0).to(tl.float32)
    r = tl.minimum(tl.maximum(r * (1.0 / 255.0), 0.0), 1.0)
    g = tl.minimum(tl.maximum(g * (1.0 / 255.0), 0.0), 1.0)
    b = tl.minimum(tl.maximum(b * (1.0 / 255.0), 0.0), 1.0)
    return r, g, b


def _jitter_normalize_kernel(img_ptr, fac_ptr, out_ptr, HW, BLOCK: tl.constexpr):
    pid = tl.program_id(0).to(tl.int64)
    img = img_ptr + pid * 3 * HW
    out = out_ptr + pid * 3 * HW
    fac = fac_ptr + pid * 8
    bf = tl.load(fac + 0)
    cf = tl.load(fac + 1)
    hf = tl.load(fac + 2)
    op0 = tl.load(fac + 3).to(tl.int32)
    op1 = tl.load(fac + 4).to(tl.int32)
    op2 = tl.load(fac + 5).to(tl.int32)
    apply = tl.load(fac + 6) > 0.5
    lanes = tl.arange(0, BLOCK)

    # sweep 1: the image up to its contrast slot, reduced to mean(gray);
    # zero trips when the jitter is off
    contrast_slot = tl.where(op0 == 1, 0, tl.where(op1 == 1, 1, 2))
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, tl.where(apply, HW, 0), BLOCK):
        offs = start + lanes
        mask = offs < HW
        r, g, b = _load_scaled(img, offs, mask, HW)
        if contrast_slot > 0:
            r, g, b = _apply_op(r, g, b, op0, bf, cf, hf, 0.0)
        if contrast_slot > 1:
            r, g, b = _apply_op(r, g, b, op1, bf, cf, hf, 0.0)
        gray = 0.2989 * r + 0.587 * g + 0.114 * b
        acc += tl.where(mask, gray, 0.0)
    mean = tl.sum(acc, axis=0) / HW

    # sweep 2: the whole chain with that mean, normalized and stored
    for start in range(0, HW, BLOCK):
        offs = start + lanes
        mask = offs < HW
        r, g, b = _load_scaled(img, offs, mask, HW)
        if apply:
            r, g, b = _apply_op(r, g, b, op0, bf, cf, hf, mean)
            r, g, b = _apply_op(r, g, b, op1, bf, cf, hf, mean)
            r, g, b = _apply_op(r, g, b, op2, bf, cf, hf, mean)
        dtype = out_ptr.dtype.element_ty
        tl.store(out + offs, ((r - 0.5) / 0.5).to(dtype), mask=mask)
        tl.store(out + HW + offs, ((g - 0.5) / 0.5).to(dtype), mask=mask)
        tl.store(out + 2 * HW + offs, ((b - 0.5) / 0.5).to(dtype), mask=mask)


def _build_kernel():
    """Import Triton and make the kernel, once; Triton compiles it at its
    first launch into ``build/triton`` of this checkout."""
    global _KERNEL, tl, _hue_shift, _apply_op, _load_scaled
    if _KERNEL is None:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        os.environ["TRITON_CACHE_DIR"] = str(_BUILD_DIR)
        import triton
        import triton.language as tl

        _hue_shift = triton.jit(_hue_shift)
        _apply_op = triton.jit(_apply_op)
        _load_scaled = triton.jit(_load_scaled)
        _KERNEL = triton.jit(_jitter_normalize_kernel)
    return _KERNEL
