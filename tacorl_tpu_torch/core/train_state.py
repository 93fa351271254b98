"""Train state (port of tacorl_tpu/core/train_state.py). PyTorch keeps the
parameters in the network and the moments in the optimizer, so the state
holds both by reference and the train step updates them in place.
``optimizer`` is one torch optimizer (Play-LMP) or a ``GroupOptimizer``
(CQL, TACO-RL); ``aux`` names auxiliary networks inside ``net`` (the CQL
target critics), which the reference state_dict keeps beside the others.

With mp-sharded parameters (``parallel/tensor_parallel.py``) the state
dict holds the full tensors, gathered over each mp group (every rank calls
``state_dict``), and ``load_state_dict`` takes full tensors and keeps this
rank's shards: a state dict has the unsharded layout at any ``mp``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from tacorl_tpu_torch.parallel.tensor_parallel import gathered_state_dict, local_state_dict

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    net: torch.nn.Module
    optimizer: Any
    aux: Optional[Dict[str, torch.nn.Module]] = None

    def state_dict(self) -> Dict[str, Any]:
        net, optimizer = gathered_state_dict(
            self.net, self.optimizer, self.net.state_dict(), self.optimizer.state_dict()
        )
        return {"step": int(self.step), "net": net, "optimizer": optimizer}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        net, optimizer = local_state_dict(self.net, self.optimizer, state["net"], state["optimizer"])
        self.step = int(state["step"])
        self.net.load_state_dict(net)
        self.optimizer.load_state_dict(optimizer)
