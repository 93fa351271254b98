"""The port's fused shift + jitter + normalize (the plain version the CUDA
kernel is held to on the card) and its fused train augmentation, held
against the JAX package on the CPU: ``fused_shift_jitter_normalize`` run
in interpret mode, ``jax.image.resize``, and ``pallas_augment_rgb_train``
with the same shifts and factors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.ops.pallas_aug import (
    fused_shift_jitter_normalize,
    pallas_augment_rgb_train,
    sample_jitter_factors as j_factors,
)
from tacorl_tpu_torch.ops import image_aug as t_aug
from tacorl_tpu_torch.ops.jitter_aug import PERM_TABLE
from tacorl_tpu_torch.ops.shift_jitter_aug import (
    fused_augment_rgb_train,
    shift_jitter_normalize,
    shift_jitter_normalize_reference,
)

SPECIAL = np.asarray(
    [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 0, 10], [250, 3, 60],
     [128, 128, 128], [0, 0, 0], [255, 255, 255], [200, 200, 10], [10, 200, 200]],
    np.float32,
)
H, W, PAD = 12, 12, 2
SPAN = 2 * PAD + 1


def _table(n, shifts, apply, rs):
    """(n, 10) factors: every op order in turn, a wide hue offset on every
    other image, the given shifts in columns 7 and 8."""
    ops = np.asarray(PERM_TABLE, np.float32)[np.arange(n) % 6]
    hue = rs.uniform(-0.02, 0.02, n)
    hue[1::2] = rs.uniform(-0.5, 0.5, len(hue[1::2]))
    return np.concatenate(
        [
            np.stack([rs.uniform(0.9, 1.1, n), rs.uniform(0.9, 1.1, n), hue], -1),
            ops,
            np.full((n, 1), apply),
            shifts.astype(np.float32),
            np.zeros((n, 1)),
        ],
        axis=-1,
    ).astype(np.float32)


@pytest.fixture(scope="module", params=[1.0, 0.0], ids=["apply", "no_apply"])
def kernel_case(request):
    """Every (dy, dx) in [0, 2p]^2 once; padded images with the special
    colours in their first rows; the JAX kernel in interpret mode."""
    rs = np.random.RandomState(0 if request.param else 1)
    dy, dx = np.meshgrid(np.arange(SPAN), np.arange(SPAN), indexing="ij")
    shifts = np.stack([dy.ravel(), dx.ravel()], -1)
    n = len(shifts)
    images = (rs.rand(n, 3, H, W) * 255).astype(np.float32)
    flat = images.reshape(n, 3, H * W)
    flat[:, :, : len(SPECIAL)] = SPECIAL.T[None]
    images = flat.reshape(n, 3, H, W)
    padded = np.pad(images, ((0, 0), (0, 0), (PAD, PAD), (PAD, PAD)), mode="edge")
    factors = _table(n, shifts, request.param, rs)
    want = np.asarray(
        fused_shift_jitter_normalize(jnp.asarray(padded), jnp.asarray(factors), PAD, interpret=True)
    )
    return images, padded, factors, want


def test_reference_matches_pallas_interpret(kernel_case):
    _, padded, factors, want = kernel_case
    got = shift_jitter_normalize_reference(torch.from_numpy(padded), torch.from_numpy(factors), PAD)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)  # tests/test_pallas_aug.py's bar


# op rows the sampler never draws but the kernel takes: contrast in two
# slots, in all three, in none
ODD_OP_ROWS = [(1, 1, 2), (1, 1, 1), (0, 2, 2), (2, 1, 1)]


@pytest.mark.parametrize("ops", ODD_OP_ROWS, ids=lambda ops: "".join(map(str, ops)))
def test_reference_any_op_row_matches_pallas_interpret(kernel_case, ops):
    _, padded, factors, _ = kernel_case
    factors = factors.copy()
    factors[:, 3:6] = ops
    want = fused_shift_jitter_normalize(jnp.asarray(padded), jnp.asarray(factors), PAD, interpret=True)
    got = shift_jitter_normalize_reference(torch.from_numpy(padded), torch.from_numpy(factors), PAD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_unpadded_input_with_clamped_shift_is_the_same(kernel_case):
    images, padded, factors, _ = kernel_case
    f = torch.from_numpy(factors)
    from_padded = shift_jitter_normalize_reference(torch.from_numpy(padded), f, PAD)
    clamped = shift_jitter_normalize_reference(torch.from_numpy(images), f, PAD, padded=False)
    assert torch.equal(clamped, from_padded)


def test_wrapper_on_cpu_takes_the_plain_path_without_counting(kernel_case):
    _, padded, factors, _ = kernel_case
    before = shift_jitter_normalize.launches
    x, f = torch.from_numpy(padded), torch.from_numpy(factors)
    assert torch.equal(shift_jitter_normalize(x, f, PAD), shift_jitter_normalize_reference(x, f, PAD))
    assert shift_jitter_normalize.launches == before


@pytest.mark.parametrize(
    "images, factors, pad, error",
    [
        (torch.zeros(2, 4, 8, 8), torch.zeros(2, 10), 1, ValueError),  # 4 channels
        (torch.zeros(2, 3, 8, 8, dtype=torch.bfloat16), torch.zeros(2, 10), 1, TypeError),
        (torch.zeros(2, 3, 8, 8), torch.zeros(2, 8), 1, ValueError),
        (torch.zeros(2, 3, 8, 8), torch.zeros(2, 10), 4, ValueError),  # nothing left
        (torch.zeros(2, 8, 8, 3).permute(0, 3, 1, 2), torch.zeros(2, 10), 1, ValueError),
        (torch.zeros(1, 3, 260, 260), torch.zeros(1, 10), 1, ValueError),  # > shared memory
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(images, factors, pad, error):
    with pytest.raises(error):
        shift_jitter_normalize(images, factors, pad)


@pytest.mark.parametrize("raw, out", [(200, 128), (40, 32), (32, 48)])
def test_antialias_resize_matches_jax_image_resize(raw, out):
    rs = np.random.RandomState(raw)
    images = rs.randint(0, 256, (2, 3, raw, raw)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(images), (2, 3, out, out), "bilinear")
    got = t_aug.resize_antialias(torch.from_numpy(images), (out, out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)  # on the 0..255 scale


def test_fused_augment_rgb_train_matches_jax():
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (2, 3, 40, 40, 3)).astype(np.uint8)
    key = jax.random.key(3)
    want = pallas_augment_rgb_train(key, jnp.asarray(images), out_hw=(32, 32), pad=PAD, interpret=True)
    # the draws pallas_augment_rgb_train makes from its key
    k_shift, k_jit = jax.random.split(key)
    shifts = jax.random.randint(k_shift, (6, 2), 0, SPAN)
    factors = j_factors(k_jit, 6)
    got = fused_augment_rgb_train(
        torch.from_numpy(images), (32, 32), PAD,
        shifts=torch.from_numpy(np.array(shifts)), factors=torch.from_numpy(np.array(factors)),
    )
    assert got.shape == want.shape == (2, 3, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_fused_augment_rgb_train_draws_from_the_generator():
    images = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (5, 20, 20, 3)).astype(np.uint8))
    outs = [
        fused_augment_rgb_train(images, (16, 16), PAD, generator=torch.Generator().manual_seed(s))
        for s in (0, 0, 1)
    ]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert outs[0].abs().max() <= 1.0
    with pytest.raises(ValueError, match="generator"):
        fused_augment_rgb_train(images, (16, 16), PAD)
