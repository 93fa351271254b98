"""Train state (port of tacorl_tpu/core/train_state.py). PyTorch keeps the
parameters in the network and the moments in the optimizer, so the state
holds both by reference and the train step updates them in place."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
