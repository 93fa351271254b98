"""Device-side per-modality transform manager (port of
tacorl_tpu/data/transforms.py).

A config of the form

    rgb_static:   {kind: rgb, size: [128, 128], pad: 6, brightness: 0.1,
                   contrast: 0.1, hue: 0.02, jitter_prob: 1.0,
                   aug_dtype: bfloat16}
    depth_static: {kind: depth, size: [128, 128], pad: 6, min_depth: 3.5,
                   max_depth: 6.3, gamma_noise: false}
    robot_obs:    {kind: vector, mean: [...], std: [...]}

maps each observation modality to a function on the device. Train applies
the full augmentation, validation the deterministic subset.

Layout: rgb inputs arrive as uint8 (..., H, W, 3) (the loader's layout),
depth inputs as float (..., H, W); both leave PLANAR, (..., 3, H', W'),
because the encoder consumes NCHW; the JAX package returns
(..., H', W', 3). The depth pipelines (resize, shift, scale, jet
colormap) are stock tensor ops: the JAX package computes them in XLA,
outside any Pallas kernel.

Two keys choose an rgb modality's train route. ``use_pallas: false``
takes the JAX package's XLA route (``image_aug.augment_rgb_train``: float32
resize, DrQ shift, clip, ``color_jitter`` with its per-image op order,
normalize). ``use_pallas`` true or absent takes the fused route: resize and
shift in ``aug_dtype``, then the jitter/normalize tail, which is the CUDA
kernel ``jitter_normalize`` unless ``use_kernel: false`` selects its plain
version. The card stands where the TPU stood, and the JAX package's
default there is the Pallas route, so a missing key keeps the fused one.

Randomness enters as data: ``draws``, nested as the states are, may hold
an rgb modality's DrQ ``shifts`` (N, 2) and jitter ``factors`` (N, 8) (the
fused route) or ``shifts`` and ``color_jitter``'s ``brightness``,
``contrast``, ``hue``, ``order`` and ``keep`` (the XLA route), a depth
modality's ``shifts`` and (with ``gamma_noise``) its ``gamma``
multiplier (a scalar, Gamma(gamma_shape) / gamma_rate), or a vector
modality's ``noise``; what is missing is drawn from the ``generator``.

``image_sizes`` gives each image modality's output (H, W), which a
``CustomEncoder`` is built with (``networks/late_fusion.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import Tensor

from tacorl_tpu_torch.ops import image_aug
from tacorl_tpu_torch.ops.jitter_aug import (
    jitter_normalize,
    jitter_normalize_reference,
    sample_jitter_factors,
)
from tacorl_tpu_torch.parallel.mesh import draw_rows
from tacorl_tpu_torch.utils import resolve_device

__all__ = ["DeviceTransforms", "image_sizes"]

_AUG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _kind(modality: str, cfg: dict) -> str:
    return cfg.get("kind", "rgb" if "rgb" in modality else "depth" if "depth" in modality else "vector")


def image_sizes(transforms: Optional[Dict[str, dict]]) -> Dict[str, Tuple[int, int]]:
    """(H, W) of each rgb or depth modality's transformed frames."""
    return {
        m: tuple(int(v) for v in cfg.get("size", (128, 128)))
        for m, cfg in (transforms or {}).items()
        if _kind(m, cfg) in ("rgb", "depth")
    }


class DeviceTransforms:
    def __init__(
        self,
        transforms: Optional[Dict[str, dict]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = {k: dict(v) for k, v in (transforms or {}).items()}
        self.device = resolve_device(device)
        self._stats: Dict[Tuple[str, str], Tuple[Tensor, Tensor]] = {}

    def _apply_one(
        self,
        modality: str,
        value: Tensor,
        train: bool,
        draws: Optional[Dict[str, Tensor]],
        generator: Optional[torch.Generator],
    ) -> Tensor:
        cfg = self.cfg.get(modality)
        if cfg is None:
            return value.float()
        kind = _kind(modality, cfg)
        if kind == "rgb":
            size = tuple(cfg.get("size", (128, 128)))
            planar = value.movedim(-1, -3)  # uint8 (..., 3, H, W)
            if train:
                return self._rgb_train(planar, cfg, size, draws or {}, generator)
            return image_aug.augment_rgb_eval(planar, out_hw=size)
        if kind == "vector":
            x = value.float()
            mean, std = self._vector_stats(modality, cfg, x.device)
            x = (x - mean) / std
            noise_std = float(cfg.get("noise_std", 0.0))
            if train and noise_std > 0.0:
                noise = (draws or {}).get("noise")
                if noise is None:
                    noise = draw_rows(
                        lambda s: torch.randn(s, generator=generator, device=x.device), x.shape
                    )
                x = x + noise * noise_std
            return x
        if kind == "depth":
            size = tuple(cfg.get("size", (128, 128)))
            lo, hi = float(cfg.get("min_depth", 0.0)), float(cfg.get("max_depth", 2.0))
            if not train:
                return image_aug.augment_depth_eval(value, size, lo, hi)
            draws = draws or {}
            x = value.float()
            if cfg.get("gamma_noise", False):
                gamma = draws.get("gamma")
                if gamma is None:
                    gamma = image_aug.sample_depth_gamma(
                        float(cfg.get("gamma_shape", 1000.0)), float(cfg.get("gamma_rate", 1000.0)),
                        x.device, generator,
                    )
                x = x * torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
            pad = int(cfg.get("pad", 6))
            shifts = draws.get("shifts")
            if shifts is None:
                n = x.reshape((-1,) + x.shape[-2:]).shape[0]
                shifts = draw_rows(
                    lambda s: torch.randint(0, 2 * pad + 1, s, generator=generator, device=x.device), (n, 2)
                )
            return image_aug.augment_depth_train(x, shifts, size, pad, lo, hi)
        raise ValueError(f"unknown transform kind {kind!r}")

    def _vector_stats(self, modality: str, cfg: dict, device) -> Tuple[Tensor, Tensor]:
        """A vector modality's mean and std (a zero std as 1) on ``device``,
        made once: a host value copied to the card makes the host wait.
        Made outside inference mode, so that a rollout's first call leaves
        tensors that training can use."""
        key = (modality, str(device))
        if key not in self._stats:
            with torch.inference_mode(False):
                mean = torch.as_tensor(cfg.get("mean", 0.0), dtype=torch.float32, device=device)
                std = torch.as_tensor(cfg.get("std", 1.0), dtype=torch.float32, device=device)
                self._stats[key] = (mean, torch.where(std == 0.0, 1.0, std))
        return self._stats[key]

    def _rgb_train(self, planar, cfg, size, draws, generator) -> Tensor:
        """``use_pallas: false``: the XLA route. Otherwise resize + DrQ shift
        (two GEMM passes in ``aug_dtype``), then the fused jitter/normalize
        tail: the CUDA kernel on CUDA unless the config sets
        ``use_kernel: false``."""
        # aug_dtype: bfloat16 halves the bytes of the resize -> shift ->
        # jitter chain; float32 keeps parity with the JAX reference in tests
        aug_dtype = str(cfg.get("aug_dtype", "float32"))
        if aug_dtype not in _AUG_DTYPES:
            raise ValueError(
                f"aug_dtype must be float32|bfloat16, got {aug_dtype!r}"
            )
        lead = planar.shape[:-3]
        flat = planar.reshape((-1,) + planar.shape[-3:])
        n = flat.shape[0]
        pad = int(cfg.get("pad", 6))
        shifts = draws.get("shifts")
        if shifts is None:
            shifts = draw_rows(
                lambda s: torch.randint(0, 2 * pad + 1, s, generator=generator, device=flat.device),
                (n, 2),
            )
        jitter = {
            "brightness": float(cfg.get("brightness", 0.1)),
            "contrast": float(cfg.get("contrast", 0.1)),
            "hue": float(cfg.get("hue", 0.02)),
        }
        prob = float(cfg.get("jitter_prob", 1.0))
        if not cfg.get("use_pallas", True):
            out = image_aug.augment_rgb_train(
                flat, shifts, size, pad, prob=prob, draws=draws, generator=generator, **jitter
            )
            return out.reshape(lead + out.shape[1:])
        x = image_aug.resize_shift(
            flat, shifts, size, pad, dtype=_AUG_DTYPES[aug_dtype]
        )
        factors = draws.get("factors")
        if factors is None:
            factors = sample_jitter_factors(n, generator, prob=prob, **jitter)
        factors = factors.to(device=x.device, dtype=torch.float32).contiguous()
        tail = jitter_normalize if cfg.get("use_kernel", True) else jitter_normalize_reference
        out = tail(x.contiguous(), factors)
        return out.reshape(lead + out.shape[1:])

    def __call__(
        self,
        states: Dict[str, Any],
        train: bool = True,
        draws: Optional[Dict[str, Dict[str, Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Transform a (possibly nested) dict of modality arrays, moved to
        the device first. ``draws`` has the nesting of ``states`` and maps
        each modality to its explicit random draws (for a flat dict:
        modality -> draws)."""

        def walk(node, path, node_draws):
            if isinstance(node, dict):
                node_draws = node_draws or {}
                return {k: walk(v, path + (k,), node_draws.get(k)) for k, v in node.items()}
            value = torch.as_tensor(node).to(self.device)
            if not path:  # flat-array observation (state-based envs)
                return value.float()
            return self._apply_one(path[-1], value, train, node_draws, generator)

        return walk(states, (), draws)
