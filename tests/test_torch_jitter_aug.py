"""The port's jitter/normalize tail and resize+shift held against the JAX
package on the CPU: ``jitter_normalize_reference`` (the plain version the
Triton kernel is held to on the card) against the Pallas kernel run in
interpret mode, and ``resize_shift`` against JAX's with JAX-drawn shifts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.ops import image_aug as j_aug
from tacorl_tpu.ops.pallas_aug import fused_jitter_normalize, sample_jitter_factors as j_factors
from tacorl_tpu_torch.ops import image_aug as t_aug
from tacorl_tpu_torch.ops.jitter_aug import (
    PERM_TABLE,
    jitter_normalize,
    jitter_normalize_reference,
    sample_jitter_factors,
)

# saturated, hue-wrapping (max = r, g < b), grey, black/white and tied-max
SPECIAL = np.asarray(
    [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 0, 10], [250, 3, 60],
     [128, 128, 128], [0, 0, 0], [255, 255, 255], [200, 200, 10], [10, 200, 200]],
    np.float32,
)


def _tail_inputs(apply, seed=0, n=12, h=16, w=16):
    """Planar (n, 3, h, w) images in 0..255 with SPECIAL colours in their
    first rows; every op order twice, one with a wide hue offset."""
    rs = np.random.RandomState(seed)
    images = (rs.rand(n, 3, h, w) * 255).astype(np.float32)
    images[:, :, : len(SPECIAL) // w + 1, :] = 0
    flat = images.reshape(n, 3, h * w)
    flat[:, :, : len(SPECIAL)] = SPECIAL.T[None]
    ops = np.asarray(PERM_TABLE, np.float32)[np.arange(n) % 6]
    hue = rs.uniform(-0.02, 0.02, n)
    hue[6:] = rs.uniform(-0.5, 0.5, n - 6)
    factors = np.concatenate(
        [
            np.stack([rs.uniform(0.9, 1.1, n), rs.uniform(0.9, 1.1, n), hue], -1),
            ops,
            np.full((n, 1), apply),
            np.zeros((n, 1)),
        ],
        axis=-1,
    ).astype(np.float32)
    return flat.reshape(n, 3, h, w), factors


@pytest.mark.parametrize("apply", [1.0, 0.0])
def test_reference_matches_pallas_interpret(apply):
    images, factors = _tail_inputs(apply)
    want = fused_jitter_normalize(jnp.asarray(images), jnp.asarray(factors), interpret=True)
    got = jitter_normalize_reference(torch.from_numpy(images), torch.from_numpy(factors))
    assert got.dtype == torch.float32
    # the bar of tests/test_pallas_aug.py
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_reference_bf16_io_matches_pallas_interpret():
    images, factors = _tail_inputs(1.0, seed=1)
    x = jnp.asarray(images).astype(jnp.bfloat16)
    want = fused_jitter_normalize(x, jnp.asarray(factors), interpret=True)
    got = jitter_normalize_reference(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(factors),
    )
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at |x| <= 1: both round the same f32 math to bf16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=8e-3
    )


def test_wrapper_on_cpu_takes_the_plain_path_without_counting():
    images, factors = _tail_inputs(1.0, seed=2)
    before = jitter_normalize.launches
    got = jitter_normalize(torch.from_numpy(images), torch.from_numpy(factors))
    want = jitter_normalize_reference(torch.from_numpy(images), torch.from_numpy(factors))
    assert torch.equal(got, want)
    assert jitter_normalize.launches == before


@pytest.mark.parametrize(
    "images, factors, error",
    [
        (torch.zeros(2, 4, 8, 8), torch.zeros(2, 8), ValueError),  # 4 channels
        (torch.zeros(2, 3, 8, 8, dtype=torch.float16), torch.zeros(2, 8), TypeError),
        (torch.zeros(2, 3, 8, 8), torch.zeros(2, 7), ValueError),
        (torch.zeros(2, 3, 8, 8), torch.zeros(2, 8, dtype=torch.float64), ValueError),
        (torch.zeros(2, 8, 8, 3).permute(0, 3, 1, 2), torch.zeros(2, 8), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(images, factors, error):
    with pytest.raises(error):
        jitter_normalize(images, factors)


def _jax_shifts(key, n, pad):
    return jax.random.randint(key, (n, 2), 0, 2 * pad + 1)


@pytest.mark.parametrize("raw, out, pad", [(40, 32, 2), (56, 48, 2), (200, 128, 6)])
def test_resize_shift_matches_jax(raw, out, pad):
    rs = np.random.RandomState(raw)
    n = 4
    images = rs.randint(0, 256, (n, raw, raw, 3)).astype(np.uint8)
    key = jax.random.key(raw)
    want = j_aug.resize_shift(key, jnp.asarray(images), (out, out), pad)
    shifts = torch.from_numpy(np.array(_jax_shifts(key, n, pad)))
    got = t_aug.resize_shift(
        torch.from_numpy(images).permute(0, 3, 1, 2), shifts, (out, out), pad
    )
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_bf16_chain_tracks_f32_chain():
    """aug_dtype=bfloat16 (the production setting): the port's bf16 resize +
    shift + tail against JAX's float32 chain on the same draws, within
    ~3 uint8 levels of [-1, 1] (tests/test_pallas_aug.py's bar)."""
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    k_shift, k_jit = jax.random.split(jax.random.key(5))
    factors = j_factors(k_jit, 4)
    x = j_aug.resize_shift(k_shift, jnp.asarray(images), (32, 32), 2)
    want = fused_jitter_normalize(jnp.transpose(x, (0, 3, 1, 2)), factors, interpret=True)

    planar = torch.from_numpy(images).permute(0, 3, 1, 2)
    shifts = torch.from_numpy(np.array(_jax_shifts(k_shift, 4, 2)))
    t_factors = torch.from_numpy(np.array(factors))
    chains = {}
    for dtype in (torch.float32, torch.bfloat16):
        y = t_aug.resize_shift(planar, shifts, (32, 32), 2, dtype=dtype).contiguous()
        chains[dtype] = jitter_normalize(y, t_factors)
    assert chains[torch.bfloat16].dtype == torch.bfloat16
    np.testing.assert_allclose(chains[torch.float32].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        chains[torch.bfloat16].float().numpy(), np.asarray(want), atol=0.025
    )


def test_augment_rgb_eval_matches_jax():
    rs = np.random.RandomState(6)
    images = rs.randint(0, 256, (2, 3, 50, 50, 3)).astype(np.uint8)
    want = j_aug.augment_rgb_eval(jnp.asarray(images), out_hw=(32, 32))
    got = t_aug.augment_rgb_eval(torch.from_numpy(images).movedim(-1, -3), (32, 32))
    assert got.shape == (2, 3, 3, 32, 32)
    np.testing.assert_allclose(got.movedim(-3, -1).numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_sample_jitter_factors_ranges_and_op_rows(prob):
    g = torch.Generator().manual_seed(0)
    f = sample_jitter_factors(4096, g, brightness=0.1, contrast=0.2, hue=0.02, prob=prob)
    assert f.shape == (4096, 8) and f.dtype == torch.float32
    assert f[:, 0].min() >= 0.9 and f[:, 0].max() <= 1.1
    assert f[:, 1].min() >= 0.8 and f[:, 1].max() <= 1.2
    assert f[:, 2].abs().max() <= 0.02
    ops = f[:, 3:6].long()
    assert torch.equal(ops.sort(dim=1).values, torch.tensor([0, 1, 2]).expand(4096, 3))
    assert len({tuple(r) for r in ops.tolist()}) == 6  # every order occurs
    assert set(f[:, 6].tolist()) == ({1.0} if prob == 1.0 else {0.0, 1.0})
    assert torch.all(f[:, 7] == 0)
