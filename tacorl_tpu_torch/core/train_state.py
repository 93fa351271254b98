"""Train state (port of tacorl_tpu/core/train_state.py). PyTorch keeps the
parameters in the network and the moments in the optimizer, so the state
holds both by reference and the train step updates them in place.
``optimizer`` is one torch optimizer (Play-LMP) or a ``GroupOptimizer``
(CQL, TACO-RL); ``aux`` names auxiliary networks inside ``net`` (the CQL
target critics), which the reference state_dict keeps beside the others."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    net: torch.nn.Module
    optimizer: Any
    aux: Optional[Dict[str, torch.nn.Module]] = None

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": int(self.step),
            "net": self.net.state_dict(),
            "optimizer": self.optimizer.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
