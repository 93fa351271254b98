"""Fused colour-jitter + normalize: a hand-written CUDA C++ kernel for
Hopper, its plain version, and the factor sampler.

Replaces ``tacorl_tpu/ops/pallas_aug.py:_jitter_kernel`` (launched by
``fused_jitter_normalize``). Per image of a planar (N, 3, H, W) batch in
0..255, f32 or bf16 IO, f32 math:

    x = clip(img / 255, 0, 1)
    y = three op slots in the image's order (factors[3:6]), any op row:
        0 brightness clip(x * b), 1 contrast clip(c * x + (1 - c) * mean(gray))
        with the mean of the image as it stands at that slot, else hue
        (RGB -> HSV, h + delta mod 1, -> RGB)
    out = (where(factors[6] > 0.5, y, x) - 0.5) / 0.5, in the input dtype

with the same (N, 8) factor table [brightness, contrast, hue, op0, op1,
op2, apply, pad] as the TPU kernel.

What bounds it on the H100: bytes (production: 1024 x 3 x 128 x 128 bf16,
100.7 MB each way), and at bf16 IO the issue rate of the hue chain's
float32 arithmetic is of the same order. The kernel source is
``tacorl_tpu_torch/csrc/jitter_normalize.cu`` (with the shared
``csrc/jitter_common.cuh``), built by nvcc for sm_90a into ``build/cuda``
at its first launch (``ops/_cuda_build.py``). Design: each image is split
over a thread-block cluster (``jitter_normalize_geometry``); every thread
loads its pixels once with 16-byte accesses, keeps them in registers
through the chain and stores them; a contrast slot's mean is a sum over the
cluster through distributed shared memory. So the image is read once and
no pixel is computed twice.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from tacorl_tpu_torch.ops._cuda_build import load_library
from tacorl_tpu_torch.ops.image_aug import (
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    normalize,
)

__all__ = [
    "jitter_normalize",
    "jitter_normalize_reference",
    "jitter_normalize_geometry",
    "sample_jitter_factors",
    "PERM_TABLE",
]

# permutation code -> per-slot op ids (0=brightness, 1=contrast, 2=hue)
PERM_TABLE = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

# Launch geometry of the two jitter kernels (csrc/jitter_common.cuh)
NUM_SMS = 132  # H100 SXM
MAX_SMEM_BYTES = 232448  # shared memory a Hopper CTA may opt into (227 KB)
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
MAX_THREADS = 256  # jitter::kMaxThreads
CHUNK = 8  # pixels of a plane per 16-byte bf16 access (jitter::kChunk)
SCRATCH_BYTES = (MAX_THREADS // 32 + 3) * 4  # sizeof(jitter::Scratch)
# grow the cluster until a call puts two CTAs on every SM, while each CTA
# keeps at least a warp's worth of chunks
_FILL_CTAS = 2 * NUM_SMS
_MIN_BAND_CHUNKS = 32
_UNSCHEDULABLE = -1  # jitter::kUnschedulable


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_shape(band_chunks: int) -> Tuple[int, int]:
    """(threads, chunks per thread) of a CTA that holds ``band_chunks``
    chunks of 8 pixels: at most ``MAX_THREADS`` threads of 1, 2 or 4
    chunks each, the fewest chunks per thread that fit."""
    k = next(k for k in (1, 2, 4) if band_chunks <= MAX_THREADS * k)
    return max(32, 32 * _cdiv(_cdiv(band_chunks, k), 32)), k


def pick_cluster(
    n: int, band_chunks: Callable[[int], int], fits: Callable[[int], bool] = lambda c: True
) -> Optional[int]:
    """The cluster size for n images whose CTAs would each hold
    ``band_chunks(c)`` chunks: the smallest size at which every thread
    holds one chunk (failing that two, then four) and ``fits(c)`` holds,
    then doubled (up to 8) while the call puts fewer than two CTAs on every
    SM and each CTA keeps at least a warp's worth of chunks. None when no
    size fits. One chunk a thread keeps a thread's registers low (48 at
    8 pixels), so more CTAs share an SM and hide each other's loads."""
    for k in (1, 2, 4):
        sizes = [c for c in CLUSTER_SIZES if band_chunks(c) <= k * MAX_THREADS and fits(c)]
        if sizes:
            c = sizes[0]
            while (n * c < _FILL_CTAS and c < CLUSTER_SIZES[-1]
                   and band_chunks(2 * c) >= _MIN_BAND_CHUNKS):
                c *= 2
            return c
    return None


def jitter_normalize_geometry(n: int, h: int, w: int) -> Dict[str, int]:
    """Launch geometry of ``jitter_normalize`` for n images of h x w: each
    image is one cluster of ``cluster`` CTAs, each CTA a band of
    ``band_chunks`` chunks of 8 pixels per plane, ``threads`` threads of
    ``chunks_per_thread`` chunks each; ``grid`` CTAs and ``smem_bytes`` of
    shared memory per CTA (``pick_cluster``). Raises ValueError for an
    image that 8 CTAs of 256 threads x 4 chunks cannot hold."""
    chunks = _cdiv(h * w, CHUNK)

    def band(c: int) -> int:
        return _cdiv(chunks, c)

    c = pick_cluster(n, band)
    if c is None:
        raise ValueError(
            f"a {h}x{w} image does not fit one cluster of {CLUSTER_SIZES[-1]} CTAs "
            f"({CLUSTER_SIZES[-1] * 4 * MAX_THREADS * CHUNK} pixels at most)"
        )
    threads, k = block_shape(band(c))
    return {
        "cluster": c, "grid": n * c, "threads": threads, "chunks_per_thread": k,
        "band_chunks": band(c), "smem_bytes": SCRATCH_BYTES,
    }


def raise_on_status(kernel: str, status: int) -> None:
    """Raise for a launcher's non-zero status (-1: the cluster shape cannot
    be scheduled; anything else a CUDA error code)."""
    if status == _UNSCHEDULABLE:
        raise RuntimeError(f"{kernel}: the cluster shape cannot be scheduled on this card")
    if status != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {status}")


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


def _library():
    lib = load_library("jitter_normalize")
    fn = lib.jitter_normalize_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def jitter_normalize(images: Tensor, factors: Tensor) -> Tensor:
    """Counterpart of ``fused_jitter_normalize``: (N, 3, H, W) float32 or
    bfloat16 in 0..255 and an (N, 8) float32 factor table (any op rows) ->
    normalized images in [-1, 1], input dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises (a failed build or launch, or a
    shape the kernel cannot take, is never replaced by the plain version)."""
    _check(images, factors)
    if images.device.type == "cpu":
        return jitter_normalize_reference(images, factors)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    n, _, h, w = images.shape
    geo = jitter_normalize_geometry(n, h, w)
    lib = _library()
    out = torch.empty_like(images)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.jitter_normalize_launch(
        images.data_ptr(), factors.data_ptr(), out.data_ptr(), n, h * w,
        int(images.dtype == torch.bfloat16), geo["cluster"], geo["threads"],
        geo["chunks_per_thread"], geo["band_chunks"], stream,
    )
    raise_on_status("jitter_normalize", status)
    jitter_normalize.launches += 1
    return out


jitter_normalize.launches = 0
