"""LateFusion perceptual encoder: one encoder per modality, concatenated
latents (port of tacorl_tpu/networks/late_fusion.py). state_dict keys are
the reference's ``networks.<modality>.*``.

``build_late_fusion`` gives a ``CustomEncoder``, whose flatten width flax
infers from the image, the modality's (H, W) from ``image_sizes``
(``data/transforms.py:image_sizes``) where its config does not set
``input_hw``.

It refuses an encoder whose BatchNorm trains (``DeepSpatialEncoder`` with
``use_batch_norm``, ``ResNet18Encoder``): one with a ``FlaxBatchNorm`` in
train mode once the encoder is put in train mode, whose running statistics
a train step would move: ``NotImplementedError(BATCHNORM_FAULT)``. The
networks themselves are ported and held against flax on their own.
``R3MEncoder`` is accepted: its frozen backbone keeps eval-mode BatchNorm
in train mode, so its statistics are buffers no step changes."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch import Tensor

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.networks.encoders import CustomEncoder, FlaxBatchNorm

__all__ = ["BATCHNORM_FAULT", "LateFusion", "build_late_fusion"]

BATCHNORM_FAULT = (
    "an encoder whose BatchNorm trains (DeepSpatialEncoder with use_batch_norm, "
    "ResNet18Encoder) inside a module is not ported: a train step would move its "
    "running statistics, and the JAX modules keep only the 'params' collection, so "
    "their train steps fail for want of 'batch_stats' (flax ScopeCollectionNotFound) "
    "and cannot run it either (ROADMAP Queue 3)"
)


def _is_image(modality: str) -> bool:
    return "rgb" in modality or "depth" in modality


class LateFusion(nn.Module):
    """``networks``: modality -> encoder module. Vector modalities pass
    through (their latent dim is the raw feature dim, in ``vector_dims``)."""

    def __init__(self, networks: Dict[str, nn.Module], vector_dims: Dict[str, int]):
        super().__init__()
        self.networks = nn.ModuleDict(networks)
        self.vector_dims = dict(vector_dims)

    def latent_dim_of(self, modality: str) -> int:
        if modality in self.vector_dims:
            return self.vector_dims[modality]
        return self.networks[modality].latent_dim

    def calc_state_dim(self, modalities: Sequence[str]) -> int:
        return sum(self.latent_dim_of(m) for m in modalities)

    def encode(
        self,
        observation: Dict[str, Tensor],
        modalities: Sequence[str],
        cat_output: bool = True,
        eps: Optional[Dict[str, Tensor]] = None,
    ):
        """Image modalities go through their encoder (planar (N, C, H, W),
        or one (C, H, W) frame); vector modalities pass through as float.
        ``eps`` maps a modality whose encoder has a VIB head to the normals
        of its sample."""
        if not isinstance(observation, dict):
            return observation
        eps = eps or {}
        state = {}
        for modality in modalities:
            value = observation[modality]
            if _is_image(modality):
                squeeze = value.dim() == 3
                if squeeze:
                    value = value[None]
                kw = {"eps": eps[modality]} if modality in eps else {}
                out = self.networks[modality](value, **kw)
                state[modality] = out[0] if squeeze else out
            else:
                state[modality] = value.float()
        if cat_output:
            return torch.cat([state[m] for m in modalities], dim=-1)
        return state

    def forward(
        self,
        observation: Dict[str, Tensor],
        modalities: Optional[Sequence[str]] = None,
        cat_output: bool = True,
    ):
        if modalities is None:
            modalities = list(self.networks) + list(self.vector_dims)
            modalities = [m for m in modalities if m in observation]
        return self.encode(observation, modalities, cat_output)


def build_late_fusion(
    networks: Dict[str, Dict[str, Any]],
    modalities: Sequence[str],
    vector_dims: Optional[Dict[str, int]] = None,
    image_sizes: Optional[Dict[str, Tuple[int, int]]] = None,
) -> LateFusion:
    """Instantiate per-modality encoders from ``_target_`` configs, keeping
    only the requested modalities."""
    vector_dims = dict(vector_dims or {})
    encoders = {}
    for modality in modalities:
        if modality in vector_dims:
            continue
        if modality not in networks:
            raise ValueError(f"network configuration for {modality!r} is missing")
        cfg = dict(networks[modality])
        cls = get_class(cfg.pop("_target_"))
        if cls is CustomEncoder and modality in (image_sizes or {}):
            cfg.setdefault("input_hw", image_sizes[modality])
        encoder = cls(**cfg)
        if any(isinstance(m, FlaxBatchNorm) and m.training for m in encoder.train().modules()):
            raise NotImplementedError(f"{modality}: {BATCHNORM_FAULT}")
        encoders[modality] = encoder
    return LateFusion(encoders, vector_dims)
