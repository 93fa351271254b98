"""The port's depth transforms held against the JAX package on the CPU:
``DeviceTransforms`` on a ``kind: depth`` modality, train (resize, DrQ
shift, optional gamma noise, scale, jet colormap, normalize) under the
shifts and the gamma multiplier JAX draws from the leaf's key, and eval
(no shift, no noise). The port returns planar (..., 3, H', W'), the JAX
package (..., H', W', 3). Also the colormap table itself and
``image_sizes``. Tolerance: atol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.data.transforms import DeviceTransforms as JaxTransforms
from tacorl_tpu.ops import image_aug as j_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.data.transforms import DeviceTransforms, image_sizes
from tacorl_tpu_torch.ops import image_aug as t_aug

B, T, H, W, SIZE, PAD = 2, 3, 20, 24, 16, 2


def _cfg(gamma):
    return {"depth_static": {"kind": "depth", "size": [SIZE, SIZE], "pad": PAD, "min_depth": 3.5,
                             "max_depth": 6.3, "gamma_noise": gamma}}


def _depth(seed=0):
    return {"depth_static": np.random.RandomState(seed).uniform(3.0, 7.0, (B, T, H, W)).astype(np.float32)}


def _planar(x):
    return np.moveaxis(np.asarray(x), -1, -3)


def test_jet_table_matches_jax():
    np.testing.assert_allclose(t_aug.jet_lut(torch.device("cpu")).numpy(), np.asarray(j_aug._jet_lut()),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("gamma", [False, True], ids=["shift", "shift_gamma"])
def test_depth_train_matches_jax_under_its_draws(gamma):
    key = jax.random.key(3)
    want = JaxTransforms(_cfg(gamma))(key, _depth(), train=True)["depth_static"]
    leaf = jax.random.fold_in(key, stable_fold("depth_static"))
    draws = {"shifts": torch.from_numpy(np.array(jax.random.randint(leaf, (B * T, 2), 0, 2 * PAD + 1)))}
    if gamma:
        draws["gamma"] = float(jax.random.gamma(jax.random.fold_in(leaf, 3), 1000.0) / 1000.0)
    got = DeviceTransforms(_cfg(gamma), device="cpu")(_depth(), train=True,
                                                      draws={"depth_static": draws})["depth_static"]
    assert got.shape == (B, T, 3, SIZE, SIZE) and want.shape == (B, T, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), _planar(want), atol=1e-5, rtol=0)


def test_depth_eval_matches_jax():
    want = JaxTransforms(_cfg(True))(jax.random.key(0), _depth(1), train=False)["depth_static"]
    got = DeviceTransforms(_cfg(True), device="cpu")(_depth(1), train=False)["depth_static"]
    np.testing.assert_allclose(got.numpy(), _planar(want), atol=1e-5, rtol=0)


def test_depth_train_draws_come_from_the_generator():
    t = DeviceTransforms(_cfg(True), device="cpu")
    outs = [t(_depth(), train=True, generator=torch.Generator().manual_seed(5))["depth_static"] for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()
    assert outs[0].min() >= -1.0 and outs[0].max() <= 1.0


def test_image_shapes_of_the_transforms():
    cfg = {**_cfg(False), "rgb_static": {"kind": "rgb", "size": [48, 40]}, "robot_obs": {"kind": "vector"}}
    assert image_sizes(cfg) == {"depth_static": (SIZE, SIZE), "rgb_static": (48, 40)}
    assert image_sizes(None) == {}
