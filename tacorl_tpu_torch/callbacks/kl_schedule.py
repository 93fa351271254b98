"""KL-beta annealing schedules (a copy of tacorl_tpu/callbacks/
kl_schedule.py; reference: utils/callbacks/kl_callbacks.py:12-71). The
schedule sets the module's host-side ``kl_beta``, which each train step
reads through ``step_scalars``."""

from __future__ import annotations

import math

from tacorl_tpu_torch.callbacks.base import Callback

__all__ = ["KLConstantSchedule", "KLLinearSchedule", "KLSigmoidSchedule"]


class KLConstantSchedule(Callback):
    def on_epoch_start(self, trainer, module, epoch: int) -> None:
        pass


class _KLSchedule(Callback):
    def __init__(self, start_epoch: int, end_epoch: int, max_kl_beta: float):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.max_kl_beta = max_kl_beta

    def on_epoch_start(self, trainer, module, epoch: int) -> None:
        module.set_kl_beta(self._anneal_fn(epoch))

    def _anneal_fn(self, epoch: int) -> float:
        raise NotImplementedError


class KLLinearSchedule(_KLSchedule):
    def _anneal_fn(self, epoch: int) -> float:
        if epoch < self.start_epoch:
            return 0.0
        if epoch > self.end_epoch:
            return self.max_kl_beta
        return (
            self.max_kl_beta
            * (epoch - self.start_epoch)
            / (self.end_epoch - self.start_epoch)
        )


class KLSigmoidSchedule(_KLSchedule):
    def _anneal_fn(self, epoch: int) -> float:
        if epoch < self.start_epoch:
            return 0.0
        if epoch > self.end_epoch:
            return self.max_kl_beta
        scale = self.end_epoch - self.start_epoch
        shift = (self.end_epoch + self.start_epoch) / 2
        return self.max_kl_beta / (1.0 + math.exp(-(epoch - shift) / (scale / 12)))
