"""Faults planted in the timed path, to show that ``correct`` catches each
fault a training cell can have:

* ``frozen``: the optimizer's step does nothing, so a train step returns
  its state unchanged;
* ``half_batch``: the loader's batches repeat their first half in their
  second, so the step's mean runs over half of the batch;
* ``altered``: an update altered where it is produced: after each Adam
  step the first parameter of every optimizer moves by one learning rate
  more;
* ``no_exchange`` (a cell on more than one chip): the exchange between
  chips left out: the gradients' mean over the ranks
  (``core/optimizers.py``'s ``all_reduce_mean``) returns each rank's own,
  so each rank steps on the mean of its own rows."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

FAULTS = ("frozen", "half_batch", "altered")
# the faults only a cell on more than one chip can have
RANK_FAULTS = ("no_exchange",)


def half(batch):
    """``batch`` with its first half repeated in its second, in place."""
    if isinstance(batch, dict):
        return {k: half(v) for k, v in batch.items()}
    n = batch.shape[0] // 2
    batch[n:2 * n] = batch[:n]
    return batch


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    if fault is None:
        yield
        return
    if fault not in FAULTS + RANK_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS + RANK_FAULTS}")
    if fault == "frozen":
        target, name = torch.optim.Adam, "step"
        replacement = lambda self, closure=None: None  # noqa: E731
    elif fault == "half_batch":
        from tacorl_tpu_torch.data import play_dataset

        target, name = play_dataset.PlayWindowDataset, "sample_batch"
        original = target.sample_batch
        replacement = lambda self, *a, **k: half(original(self, *a, **k))  # noqa: E731
    elif fault == "no_exchange":
        from tacorl_tpu_torch.core import optimizers

        target, name = optimizers, "all_reduce_mean"
        replacement = list
    else:
        target, name = torch.optim.Adam, "step"
        original = torch.optim.Adam.step

        def replacement(self, closure=None):
            out = original(self, closure)
            with torch.no_grad():
                group = self.param_groups[0]
                group["params"][0].add_(float(group["lr"]))
            return out
    saved = getattr(target, name)
    setattr(target, name, replacement)
    try:
        yield
    finally:
        setattr(target, name, saved)
