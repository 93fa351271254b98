"""The XLA rgb route (``use_pallas: false``) held against the JAX package's
``image_aug.augment_rgb_train`` and ``DeviceTransforms`` on the same uint8
frames, under JAX's own key splits re-made as explicit draws. Tolerance:
atol 2e-5 in float32. The port is planar (..., 3, H, W), JAX
(..., H, W, 3)."""

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.data.transforms import DeviceTransforms as JaxTransforms
from tacorl_tpu.ops import image_aug as jax_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.data.transforms import DeviceTransforms
from tacorl_tpu_torch.ops import image_aug

ATOL = 2e-5


def _frames(seed=0, lead=(2, 3), hw=40):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, lead + (hw, hw, 3)).astype(np.uint8)


def _jax_route_draws(key, n, pad, brightness=0.1, contrast=0.1, hue=0.02, prob=1.0):
    """The draws ``augment_rgb_train(key, ...)`` makes: the shift key and
    the five keys ``color_jitter`` splits, in JAX's order."""
    k_shift, k_jit = jax.random.split(key)
    k_b, k_c, k_h, k_ord, k_p = jax.random.split(k_jit, 5)

    def uni(k, lo, hi, shape=(n,)):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi)))

    # the JAX sampler draws (n, 1, 1, 1); the same keys give the same values at (n,)
    draws = {
        "shifts": torch.from_numpy(np.array(jax.random.randint(k_shift, (n, 2), 0, 2 * pad + 1))),
        "brightness": uni(k_b, max(0.0, 1.0 - brightness), 1.0 + brightness),
        "contrast": uni(k_c, max(0.0, 1.0 - contrast), 1.0 + contrast),
        "hue": uni(k_h, -hue, hue),
        "order": torch.from_numpy(np.array(jax.numpy.argsort(jax.random.uniform(k_ord, (n, 3)), axis=-1))),
    }
    if prob < 1.0:
        draws["keep"] = torch.from_numpy(np.array(jax.random.uniform(k_p, (n,)) < prob))
    return draws


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_augment_rgb_train_matches_jax(prob):
    frames = _frames(lead=(6,))
    key = jax.random.key(11)
    want = jax_aug.augment_rgb_train(key, frames, out_hw=(32, 32), pad=3, hue=0.2, prob=prob)
    draws = _jax_route_draws(key, 6, 3, hue=0.2, prob=prob)
    shifts = draws.pop("shifts")
    got = image_aug.augment_rgb_train(
        torch.from_numpy(frames).movedim(-1, -3), shifts, (32, 32), 3, hue=0.2, prob=prob, draws=draws
    )
    assert got.shape == (6, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.movedim(-3, -1).numpy(), np.asarray(want), atol=ATOL)
    if prob < 1.0:  # both kept and skipped images are in the batch
        assert 0 < int(draws["keep"].sum()) < 6


def test_every_op_order_is_applied_per_image():
    """Six images, one for each of the six orders: each goes through its own
    order, as ``jax.lax.switch`` applies it."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.rand(6, 3, 8, 8).astype(np.float32))
    orders = torch.tensor([[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1], [2, 1, 0]])
    draws = {
        "brightness": torch.full((6,), 1.08), "contrast": torch.full((6,), 0.93),
        "hue": torch.full((6,), 0.15), "order": orders,
    }
    got = image_aug.color_jitter(x, draws=draws)
    ops = [
        lambda im: image_aug.adjust_brightness(im, torch.tensor(1.08)),
        lambda im: image_aug.adjust_contrast(im, torch.tensor(0.93)),
        lambda im: image_aug.adjust_hue(im, torch.full((1, 1, 1), 0.15)),
    ]
    for i in range(6):
        im = x[i]
        for op in orders[i].tolist():
            im = ops[op](im)
        torch.testing.assert_close(got[i], im, rtol=0, atol=1e-6)


@pytest.mark.parametrize("jitter_prob", [1.0, 0.5])
def test_device_transforms_use_pallas_false_matches_jax(jitter_prob):
    cfg = {"rgb_static": {
        "kind": "rgb", "size": [32, 32], "pad": 2, "use_pallas": False, "jitter_prob": jitter_prob,
    }}
    frames = _frames(1)
    key = jax.random.key(7)
    want = JaxTransforms(cfg)(key, {"rgb_static": frames}, train=True)
    leaf = jax.random.fold_in(key, stable_fold("rgb_static"))
    draws = {"rgb_static": _jax_route_draws(leaf, 6, 2, prob=jitter_prob)}
    got = DeviceTransforms(cfg, device="cpu")({"rgb_static": frames}, train=True, draws=draws)
    out = got["rgb_static"]
    assert out.shape == (2, 3, 3, 32, 32)
    np.testing.assert_allclose(out.movedim(-3, -1).numpy(), np.asarray(want["rgb_static"]), atol=ATOL)


def test_the_routes_differ_and_a_missing_key_keeps_the_fused_one():
    """``use_pallas`` absent or true: the fused route (its own factor table);
    false: the XLA route. On the same generator seed the two routes give
    different images, and the fused route is what an absent key selects."""
    frames = _frames(2)
    outs = {}
    for name, extra in (("absent", {}), ("true", {"use_pallas": True}), ("false", {"use_pallas": False})):
        cfg = {"rgb_static": {"kind": "rgb", "size": [32, 32], "pad": 2, **extra}}
        gen = torch.Generator().manual_seed(0)
        outs[name] = DeviceTransforms(cfg, device="cpu")({"rgb_static": frames}, generator=gen)["rgb_static"]
    torch.testing.assert_close(outs["absent"], outs["true"], rtol=0, atol=0)
    assert (outs["absent"] - outs["false"]).abs().max() > 1e-3
    assert outs["false"].abs().max() <= 1.0


def test_draws_come_from_the_generator_when_absent():
    frames = torch.from_numpy(_frames(3, lead=(4,))).movedim(-1, -3)
    shifts = torch.zeros(4, 2, dtype=torch.long)
    a = image_aug.augment_rgb_train(frames, shifts, (16, 16), 0, generator=torch.Generator().manual_seed(1))
    b = image_aug.augment_rgb_train(frames, shifts, (16, 16), 0, generator=torch.Generator().manual_seed(1))
    c = image_aug.augment_rgb_train(frames, shifts, (16, 16), 0, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0
    draws = image_aug.sample_color_jitter(5, torch.Generator().manual_seed(0), prob=0.5)
    assert sorted(draws) == ["brightness", "contrast", "hue", "keep", "order"]
    assert draws["order"].shape == (5, 3) and draws["keep"].dtype == torch.bool
    assert ((draws["brightness"] >= 0.9) & (draws["brightness"] <= 1.1)).all()
