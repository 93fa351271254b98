"""Trainer callback protocol (a copy of tacorl_tpu/callbacks/base.py, the
reference's Lightning Callback layer)."""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["Callback"]


class Callback:
    def on_fit_start(self, trainer, module) -> None: ...

    def on_epoch_start(self, trainer, module, epoch: int) -> None: ...

    def on_train_batch_end(
        self, trainer, module, metrics: Dict[str, Any], step: int
    ) -> None: ...

    def on_validation_end(
        self,
        trainer,
        module,
        metrics: Dict[str, Any],
        outputs: Optional[list],
        epoch: int,
    ) -> None: ...

    def on_epoch_end(self, trainer, module, epoch: int) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    # checkpoint-persisted callback state (the uncertainty-horizon callback
    # rides its state inside the checkpoint, increase_horizon_uncertainty.py:
    # 87-114)
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...
