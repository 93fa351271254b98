"""The port's DeviceTransforms held against tacorl_tpu.data.transforms on
the same uint8 windows and JAX's own draws. The JAX rgb train path runs its
Pallas tail in interpret mode (its ``pallas_call`` cannot run on the CPU
otherwise); the port returns planar (..., 3, H, W), JAX (..., H, W, 3)."""

import functools

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.data.transforms import DeviceTransforms as JaxTransforms
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.data.transforms import DeviceTransforms
from tacorl_tpu_torch.ops.jitter_aug import jitter_normalize

RGB = {"kind": "rgb", "size": [32, 32], "pad": 2, "use_pallas": True}


def _frames(seed=0, b=2, t=3, hw=40):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (b, t, hw, hw, 3)).astype(np.uint8)


def _jax_rgb_draws(key, modality, n, pad):
    """The shifts and factors JAX's _pallas_rgb_train draws for a leaf."""
    leaf = jax.random.fold_in(key, stable_fold(modality))
    k_shift, k_jit = jax.random.split(leaf)
    shifts = jax.random.randint(k_shift, (n, 2), 0, 2 * pad + 1)
    factors = pallas_aug.sample_jitter_factors(k_jit, n)
    return {
        "shifts": torch.from_numpy(np.array(shifts)),
        "factors": torch.from_numpy(np.array(factors)),
    }


@pytest.fixture
def interpret_tail(monkeypatch):
    monkeypatch.setattr(
        pallas_aug, "pallas_augment_tail",
        functools.partial(pallas_aug.pallas_augment_tail, interpret=True),
    )


def test_rgb_train_matches_jax_pallas_path(interpret_tail):
    frames = _frames()
    key = jax.random.key(3)
    want = JaxTransforms({"rgb_static": RGB})(key, {"rgb_static": frames}, train=True)
    draws = {"rgb_static": _jax_rgb_draws(key, "rgb_static", 6, 2)}
    got = DeviceTransforms({"rgb_static": RGB}, device="cpu")(
        {"rgb_static": frames}, train=True, draws=draws
    )
    out = got["rgb_static"]
    assert out.shape == (2, 3, 3, 32, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.movedim(-3, -1).numpy(), np.asarray(want["rgb_static"]), atol=2e-5
    )


def test_rgb_eval_matches_jax():
    frames = _frames(1)
    want = JaxTransforms({"rgb_static": RGB})(jax.random.key(0), {"rgb_static": frames}, train=False)
    got = DeviceTransforms({"rgb_static": RGB}, device="cpu")({"rgb_static": frames}, train=False)
    np.testing.assert_allclose(
        got["rgb_static"].movedim(-3, -1).numpy(), np.asarray(want["rgb_static"]), atol=1e-5
    )


@pytest.mark.parametrize("train", [False, True])
def test_vector_kind_matches_jax(train):
    rs = np.random.RandomState(2)
    obs = rs.randn(4, 5, 6).astype(np.float32)
    cfg = {"robot_obs": {
        "kind": "vector", "mean": [0.1] * 6, "std": [2.0, 0.0, 1.0, 1.0, 0.5, 3.0],
        "noise_std": 0.1,
    }}
    key = jax.random.key(4)
    want = JaxTransforms(cfg)(key, {"robot_obs": obs}, train=train)
    draws = None
    if train:  # JAX's noise draw for this leaf
        leaf = jax.random.fold_in(key, stable_fold("robot_obs"))
        noise = jax.random.normal(jax.random.fold_in(leaf, 5), obs.shape)
        draws = {"robot_obs": {"noise": torch.from_numpy(np.array(noise))}}
    got = DeviceTransforms(cfg, device="cpu")({"robot_obs": obs}, train=train, draws=draws)
    np.testing.assert_allclose(
        got["robot_obs"].numpy(), np.asarray(want["robot_obs"]), atol=1e-6
    )


def test_unconfigured_and_flat_observations_become_float():
    t = DeviceTransforms({}, device="cpu")
    out = t({"scene_obs": np.arange(6, dtype=np.int64).reshape(2, 3)})
    assert out["scene_obs"].dtype == torch.float32
    flat = t(np.ones((2, 3), np.float64))
    assert flat.dtype == torch.float32 and flat.shape == (2, 3)


def test_use_kernel_false_takes_the_plain_tail():
    frames = _frames(5)
    draws = {"rgb_static": {
        "shifts": torch.zeros(6, 2, dtype=torch.long),
        "factors": torch.tensor([[1.05, 0.95, 0.01, 2, 1, 0, 1, 0]] * 6),
    }}
    outs = []
    for use_kernel in (True, False):
        cfg = {"rgb_static": dict(RGB, use_kernel=use_kernel)}
        outs.append(DeviceTransforms(cfg, device="cpu")(
            {"rgb_static": frames}, train=True, draws=draws
        )["rgb_static"])
    assert torch.equal(outs[0], outs[1])
    assert jitter_normalize.launches == 0  # no card here: nothing launched


def test_bf16_aug_dtype_and_generator_draws():
    cfg = {"rgb_static": dict(RGB, aug_dtype="bfloat16")}
    g = torch.Generator().manual_seed(0)
    out = DeviceTransforms(cfg, device="cpu")(
        {"rgb_static": _frames(6)}, train=True, generator=g
    )["rgb_static"]
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 3, 32, 32)
    assert out.float().abs().max() <= 1.0


def test_aug_dtype_is_validated():
    cfg = {"rgb_static": dict(RGB, aug_dtype="float16")}
    with pytest.raises(ValueError, match="aug_dtype"):
        DeviceTransforms(cfg, device="cpu")(
            {"rgb_static": _frames()}, train=True, generator=torch.Generator()
        )
