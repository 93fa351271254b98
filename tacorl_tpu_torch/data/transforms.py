"""Device-side per-modality transform manager (port of
tacorl_tpu/data/transforms.py).

A config of the form

    rgb_static: {kind: rgb, size: [128, 128], pad: 6, brightness: 0.1,
                 contrast: 0.1, hue: 0.02, jitter_prob: 1.0,
                 aug_dtype: bfloat16}
    robot_obs:  {kind: vector, mean: [...], std: [...]}

maps each observation modality to a function on the device. Train applies
the full augmentation, validation the deterministic subset.

Layout: rgb inputs arrive as uint8 (..., H, W, 3) (the loader's layout) and
leave PLANAR, (..., 3, H', W'), because the encoder consumes NCHW; the JAX
package returns (..., H', W', 3).

Randomness enters as data: ``draws``, nested as the states are, may hold
an rgb modality's DrQ ``shifts`` (N, 2) and jitter ``factors`` (N, 8), or
a vector modality's ``noise``; what is missing is drawn from the
``generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import Tensor

from tacorl_tpu_torch.ops import image_aug
from tacorl_tpu_torch.ops.jitter_aug import (
    jitter_normalize,
    jitter_normalize_reference,
    sample_jitter_factors,
)
from tacorl_tpu_torch.utils import resolve_device

__all__ = ["DeviceTransforms"]

_AUG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DeviceTransforms:
    def __init__(
        self,
        transforms: Optional[Dict[str, dict]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = {k: dict(v) for k, v in (transforms or {}).items()}
        self.device = resolve_device(device)

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
        kind = cfg.get("kind", "rgb" if "rgb" in modality else
                       "depth" if "depth" in modality else "vector")
        if kind == "rgb":
            size = tuple(cfg.get("size", (128, 128)))
            planar = value.movedim(-1, -3)  # uint8 (..., 3, H, W)
            if train:
                return self._rgb_train(planar, cfg, size, draws or {}, generator)
            return image_aug.augment_rgb_eval(planar, out_hw=size)
        if kind == "vector":
            x = value.float()
            mean = torch.as_tensor(cfg.get("mean", 0.0), dtype=torch.float32, device=x.device)
            std = torch.as_tensor(cfg.get("std", 1.0), dtype=torch.float32, device=x.device)
            std = torch.where(std == 0.0, 1.0, std)
            x = (x - mean) / std
            noise_std = float(cfg.get("noise_std", 0.0))
            if train and noise_std > 0.0:
                noise = (draws or {}).get("noise")
                if noise is None:
                    noise = torch.randn(
                        x.shape, generator=generator, device=x.device
                    )
                x = x + noise * noise_std
            return x
        if kind == "depth":
            raise NotImplementedError(
                "depth transforms are not ported yet (see ROADMAP.md)"
            )
        raise ValueError(f"unknown transform kind {kind!r}")

    def _rgb_train(self, planar, cfg, size, draws, generator) -> Tensor:
        """Resize + DrQ shift (two GEMM passes in ``aug_dtype``), then the
        fused jitter/normalize tail: the CUDA kernel on CUDA unless the
        config sets ``use_kernel: false`` (counterpart of ``use_pallas``)."""
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
            shifts = torch.randint(
                0, 2 * pad + 1, (n, 2), generator=generator, device=flat.device
            )
        x = image_aug.resize_shift(
            flat, shifts, size, pad, dtype=_AUG_DTYPES[aug_dtype]
        )
        factors = draws.get("factors")
        if factors is None:
            factors = sample_jitter_factors(
                n,
                generator,
                brightness=float(cfg.get("brightness", 0.1)),
                contrast=float(cfg.get("contrast", 0.1)),
                hue=float(cfg.get("hue", 0.02)),
                prob=float(cfg.get("jitter_prob", 1.0)),
            )
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
