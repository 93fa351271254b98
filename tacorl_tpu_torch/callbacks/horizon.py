"""Goal-horizon curricula (a copy of tacorl_tpu/callbacks/horizon.py;
reference: utils/callbacks/increase_horizon.py). The uncertainty-gated
variant is ``callbacks/horizon_uncertainty.py``."""

from __future__ import annotations

from tacorl_tpu_torch.callbacks.base import Callback

__all__ = ["IncreaseHorizonLinear", "IncreaseHorizonConstant"]


class IncreaseHorizonLinear(Callback):
    """Per-epoch linear horizon growth on datasets exposing
    increase_horizon() and goal_strategy_prob (increase_horizon.py:5-24)."""

    def on_epoch_end(self, trainer, module, epoch: int) -> None:
        ds = getattr(trainer.datamodule, "train_dataset", None)
        if (
            ds is None
            or not hasattr(ds, "goal_strategy_prob")
            or not hasattr(ds, "current_horizon")
        ):
            return
        if trainer.sink is not None:
            trainer.sink.log(
                {"goal_horizon": float(ds.current_horizon)},
                step=trainer.global_step,
                prefix="train",
            )
        if "increasing_horizon" in ds.goal_strategy_prob:
            ds.increase_horizon(epoch=epoch + 1)


class IncreaseHorizonConstant(Callback):
    pass
