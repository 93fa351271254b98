"""Uncertainty-gated goal-horizon curriculum (port of
tacorl_tpu/callbacks/horizon_uncertainty.py; reference:
utils/callbacks/increase_horizon_uncertainty.py:12-114).

After each train batch, ``forward_passes`` MC-dropout evaluations of both
critics on (obs, dataset actions), each with its own dropout mask; at epoch
end, if the mean over the epoch of the predictions' (population) std is
below ``std_threshold`` the goal horizon grows by one ``horizon_step``. The
per-batch std stays on the device; the epoch end copies them to the host
once. The current horizon rides in the trainer's callback state
(``callbacks_state.json``), so a resumed run continues the curriculum.

Requires critics built with ``q_network.with_dropout: true``.

Under the trainer's K-step dispatch the callback runs once a chunk, on the
stacked (K, B, ...) chunk, as the JAX callback does: on vector observations
the std is taken over the whole chunk. On image observations the JAX
callback fails (its conv encoder rejects the 5-d frames), so the port
raises ``NotImplementedError(CHUNK_FAULT)`` (ROADMAP Queue 3).

Data-parallel: the batch is a rank's rows, so the masks are drawn as that
rank's rows of the global batch's (``parallel.mesh.sharded_draws``) and
each batch's std is averaged over the ranks: every rank sees the global
batch's statistic and grows the horizon at the same epoch."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import Tensor

from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.data.loader import flatten
from tacorl_tpu_torch.parallel.mesh import sharded_draws, sync_metrics

__all__ = ["CHUNK_FAULT", "IncreaseHorizonUncertainty"]

CHUNK_FAULT = (
    "the uncertainty-gated horizon on a K-step chunk of image observations is not "
    "ported: the JAX callback evaluates the stacked (K, B, ...) chunk and its conv "
    "encoder rejects the 5-d frames (TypeError), so it cannot run either; train "
    "with trainer.steps_per_call=1 or vector observations (ROADMAP Queue 3)"
)


class IncreaseHorizonUncertainty(Callback):
    def __init__(self, forward_passes: int = 3, std_threshold: float = 0.125):
        # coerce: YAML 1.1 scalars like "1e9" arrive as strings
        self.forward_passes = int(forward_passes)
        self.std_threshold = float(std_threshold)
        self._stds: List[Tensor] = []
        self._trainer = None
        self._restored_horizon: Optional[int] = None

    def _dataset(self, trainer):
        return getattr(trainer.datamodule, "train_dataset", None)

    def _active(self, trainer) -> bool:
        ds = self._dataset(trainer)
        return (
            ds is not None
            and hasattr(ds, "goal_strategy_prob")
            and "increasing_horizon" in ds.goal_strategy_prob
        )

    @torch.no_grad()
    def mc_std(
        self,
        module,
        net,
        batch: Dict[str, Any],
        masks: Optional[Sequence[Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """The mean over the batch of the std of the 2 x ``forward_passes``
        Q predictions (q1 and q2 in turn, pass by pass). ``masks`` holds a
        keep mask per forward in that order; without them each forward
        draws its own from ``generator``."""
        obs = module.transforms(batch["observations"], train=False)
        actions = torch.as_tensor(batch["actions"]).to(module.device, torch.float32)
        preds = []
        for i in range(self.forward_passes):
            for j, name in enumerate(("q1", "q2")):
                mask = None if masks is None else masks[2 * i + j]
                preds.append(getattr(net, name)(obs, actions, mask, generator))
        return torch.std(torch.stack(preds), dim=0, correction=0).mean()

    def on_train_batch_end(self, trainer, module, metrics, step) -> None:
        batch = getattr(trainer, "_current_batch", None)
        if batch is None or not self._active(trainer):
            return
        if _stacked_images(batch):
            raise NotImplementedError(CHUNK_FAULT)
        with sharded_draws():
            std = self.mc_std(module, trainer.state.net, batch, generator=module.generator)
        self._stds.append(sync_metrics({"std": std})["std"])

    def on_epoch_end(self, trainer, module, epoch: int) -> None:
        if not self._active(trainer) or not self._stds:
            return
        ds = self._dataset(trainer)
        stds = torch.stack(self._stds).cpu().double()  # the epoch's one host copy
        self._stds = []
        avg_std = float(stds.mean())
        trainer.sink.log(
            {"goal_horizon": float(ds.current_horizon), "Q_avg_std": avg_std},
            trainer.global_step,
            prefix="train",
        )
        if avg_std < self.std_threshold:
            ds.increase_horizon_to(ds.current_horizon + ds.horizon_step)

    # -- callback state rides in the trainer's run dir ------------------------

    def state_dict(self) -> Dict[str, Any]:
        ds = self._dataset(self._trainer) if self._trainer else None
        if ds is not None and hasattr(ds, "current_horizon"):
            return {"current_horizon": int(ds.current_horizon)}
        return {}

    def on_fit_start(self, trainer, module) -> None:
        self._trainer = trainer
        ds = self._dataset(trainer)
        if self._restored_horizon is not None and ds is not None and hasattr(ds, "increase_horizon_to"):
            ds.increase_horizon_to(self._restored_horizon)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if "current_horizon" in state:
            self._restored_horizon = int(state["current_horizon"])


def _stacked_images(batch) -> bool:
    """A stacked chunk ((K, B, A) actions) with image observations
    ((K, B, H, W, C) frames)."""
    return len(batch["actions"].shape) == 3 and any(
        len(x.shape) >= 5 for _, x in flatten(batch["observations"])
    )
