"""Algorithm-module base (port of tacorl_tpu/modules/base.py): config-driven
construction on an explicit device. A module owns its network definition,
the train step it makes, and host-side schedule state (e.g. ``kl_beta``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.utils import resolve_device

__all__ = ["AlgorithmModule"]


class AlgorithmModule:
    name: str = "module"

    def __init__(
        self,
        cfg: Dict[str, Any],
        full_config: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = dict(cfg)
        self.full_config = full_config or {}
        self.device = resolve_device(device)
        self.build()

    # subclasses implement ------------------------------------------------
    def build(self) -> None:
        raise NotImplementedError

    def init_state(self, seed: int = 0) -> TrainState:
        raise NotImplementedError

    def make_train_step(self):
        raise NotImplementedError

    def make_val_step(self):
        raise NotImplementedError

    # scalar schedule values passed into each train step (e.g. kl_beta
    # annealing); callbacks mutate these host attributes
    def step_scalars(self) -> Dict[str, float]:
        return {}
