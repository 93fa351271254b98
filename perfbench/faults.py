"""Faults planted in the timed path, to show that ``correct`` catches each
fault a training cell on one chip can have:

* ``frozen``: the optimizer's step does nothing, so a train step returns
  its state unchanged;
* ``half_batch``: the loader's batches repeat their first half in their
  second, so the step's mean runs over half of the batch;
* ``altered``: an update altered where it is produced: after each Adam
  step the first parameter of every optimizer moves by one learning rate
  more.

A four-chip cell adds the exchange between chips left out, which no
one-chip cell has."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

FAULTS = ("frozen", "half_batch", "altered")


def _half(batch):
    if isinstance(batch, dict):
        return {k: _half(v) for k, v in batch.items()}
    n = batch.shape[0] // 2
    batch[n:2 * n] = batch[:n]
    return batch


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if fault == "frozen":
        target, name = torch.optim.Adam, "step"
        replacement = lambda self, closure=None: None  # noqa: E731
    elif fault == "half_batch":
        from tacorl_tpu_torch.data import play_dataset

        target, name = play_dataset.PlayWindowDataset, "sample_batch"
        original = target.sample_batch
        replacement = lambda self, *a, **k: _half(original(self, *a, **k))  # noqa: E731
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
