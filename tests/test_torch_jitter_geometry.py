"""Launch geometry of the two CUDA jitter kernels, on the CPU: what
``jitter_normalize_geometry`` and ``shift_jitter_normalize_geometry`` hand
to the launchers fits a Hopper CTA, fills the card, covers every pixel of
an image exactly once under each kernel's pixel layout, and agrees with
the constants of ``csrc/jitter_common.cuh``; shapes that do not fit raise."""

import re

import pytest

from tacorl_tpu_torch.ops import jitter_aug
from tacorl_tpu_torch.ops._cuda_build import CSRC_DIR
from tacorl_tpu_torch.ops.jitter_aug import (
    CHUNK,
    CLUSTER_SIZES,
    MAX_SMEM_BYTES,
    MAX_THREADS,
    NUM_SMS,
    jitter_normalize_geometry,
)
from tacorl_tpu_torch.ops.shift_jitter_aug import shift_jitter_normalize_geometry

# (n, h, w): production windows and goals, the 84x84 gripper camera, the
# tests' tiny frames, a frame that is not a multiple of 8 pixels
SHAPES = [
    (1024, 128, 128), (64, 128, 128), (1024, 84, 84), (64, 84, 84),
    (15, 48, 48), (12, 16, 16), (3, 50, 50), (1, 200, 200),
]


def _valid_block(geo):
    assert geo["cluster"] in CLUSTER_SIZES
    assert geo["grid"] % geo["cluster"] == 0
    assert geo["threads"] % 32 == 0 and 0 < geo["threads"] <= MAX_THREADS
    assert geo["chunks_per_thread"] in (1, 2, 4)
    assert geo["smem_bytes"] <= MAX_SMEM_BYTES


@pytest.mark.parametrize("n, h, w", SHAPES)
def test_jitter_normalize_geometry_covers_each_pixel_once(n, h, w):
    geo = jitter_normalize_geometry(n, h, w)
    _valid_block(geo)
    assert geo["grid"] == n * geo["cluster"]
    # csrc/jitter_normalize.cu: thread t of CTA rank holds chunks
    # rank * band + t + k * threads (k < K) that lie in the band
    owned = []
    band, threads, k_max = geo["band_chunks"], geo["threads"], geo["chunks_per_thread"]
    for rank in range(geo["cluster"]):
        for t in range(threads):
            for k in range(k_max):
                local = t + k * threads
                if local < band:
                    at = (rank * band + local) * CHUNK
                    owned += [p for p in range(at, at + CHUNK) if p < h * w]
    assert sorted(owned) == list(range(h * w))


@pytest.mark.parametrize("n, h, w", SHAPES)
@pytest.mark.parametrize("pad", [0, 6], ids=["unpadded", "padded"])
def test_shift_jitter_geometry_covers_each_pixel_once(n, h, w, pad):
    in_h, in_w = h + 2 * pad, w + 2 * pad
    geo = shift_jitter_normalize_geometry(n, in_h, in_w, h, w)
    _valid_block(geo)
    assert geo["smem_bytes"] == 3 * geo["band_rows"] * in_w * 4 + jitter_aug.SCRATCH_BYTES
    # csrc/shift_jitter.cu: CTA rank owns output rows [rank * band_rows, ...),
    # thread t its band's pixels t + threads * i, i < P
    p_max, threads = geo["chunks_per_thread"] * CHUNK, geo["threads"]
    owned = []
    for rank in range(geo["cluster"]):
        r0 = rank * geo["band_rows"]
        band_px = max(0, min(h, r0 + geo["band_rows"]) - r0) * w
        for t in range(threads):
            owned += [r0 * w + t + threads * i for i in range(p_max) if t + threads * i < band_px]
    assert sorted(owned) == list(range(h * w))


@pytest.mark.parametrize("n", [64, 1024])
def test_production_shapes_fill_the_card(n):
    """At least one CTA per SM for the stage-2 goal call (N=64) and the
    window call (N=1024), for both kernels."""
    assert jitter_normalize_geometry(n, 128, 128)["grid"] >= NUM_SMS
    assert shift_jitter_normalize_geometry(n, 128, 128, 128, 128)["grid"] >= NUM_SMS
    assert shift_jitter_normalize_geometry(n, 140, 140, 128, 128)["grid"] >= NUM_SMS


def test_production_shift_band_shares_an_sm():
    """A 128x128 band of source rows leaves room for several CTAs per SM."""
    for in_hw in (128, 140):
        geo = shift_jitter_normalize_geometry(1024, in_hw, in_hw, 128, 128)
        assert MAX_SMEM_BYTES // geo["smem_bytes"] >= 4


@pytest.mark.parametrize(
    "make",
    [
        lambda: jitter_normalize_geometry(1, 257, 257),  # > 8 CTAs x 256 threads x 32 pixels
        lambda: shift_jitter_normalize_geometry(1, 260, 260, 258, 258),
        lambda: shift_jitter_normalize_geometry(1, 16, 20000, 16, 19990),  # a row > shared memory
    ],
)
def test_shapes_that_cannot_fit_raise(make):
    with pytest.raises(ValueError, match="does not fit"):
        make()


def test_constants_match_the_shared_header():
    header = (CSRC_DIR / "jitter_common.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (-?\d+);", header).group(1))

    assert constant("kMaxThreads") == MAX_THREADS
    assert constant("kChunk") == CHUNK
    assert constant("kUnschedulable") == jitter_aug._UNSCHEDULABLE
    # struct Scratch: a float per warp and a part per op slot
    assert re.search(r"float warp\[kMaxThreads / 32\];\s*float part\[3\];", header)
    assert jitter_aug.SCRATCH_BYTES == (MAX_THREADS // 32 + 3) * 4
