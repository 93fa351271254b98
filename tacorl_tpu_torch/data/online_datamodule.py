"""Online-RL data module (port of tacorl_tpu/data/online_datamodule.py;
reference: datamodule/online_rl_data_module.py:12-36,
datamodule/dataset/rl_dataset.py:11-61): an epoch is ``steps_per_epoch``
batches sampled from the module's live replay buffer.

The loader samples on the training thread, not on loader threads: the train
step appends to the buffer (and evicts its oldest transition once it is
full) between two samples, so a thread indexing the deque at the same time
would race with it. The trainer's ``device_prefetch`` draws batch k+1
before step k runs, in both packages, so each batch sees the buffer as it
was before the previous step's env step. One generator,
``default_rng(seed)``, made by ``train_loader`` and advanced across epochs,
draws every batch, so the batches are bit-equal to the JAX loader's. With
``pin_memory`` set (the trainer sets it on a card), each batch's arrays are
copied into page-locked tensors, so the copy to the card can run
asynchronously. With ``shard`` a rank's ``parallel.mesh.BatchShard`` (the
trainer sets it), each batch is that rank's rows of the global sample:
every rank plays the same seeded env stream and keeps the same buffer, as
the JAX package's one controller shards one sample over its chips.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tacorl_tpu_torch.data.loader import _pinned, tree_map
from tacorl_tpu_torch.parallel.mesh import BatchShard

__all__ = ["OnlineRLDataModule"]


class _BufferLoader:
    def __init__(self, module, batch_size: int, steps_per_epoch: int, seed: int):
        self.module = module
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.rng = np.random.default_rng(seed)
        self.pin_memory = False
        self.shard = BatchShard()

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self) -> Iterator:
        for _ in range(self.steps_per_epoch):
            rows = self.shard.rows(self.batch_size)
            batch = self.module.replay_buffer.sample(self.batch_size, self.rng, rows)
            yield tree_map(_pinned, batch) if self.pin_memory else batch


class OnlineRLDataModule:
    """The trainer hands the module over through ``set_module`` (the
    reference's train.py:43-45 injection); there is no validation split."""

    def __init__(self, batch_size: int = 64, steps_per_epoch: int = 1000, seed: int = 0, **_):
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self.module = None
        self.train_dataset = None

    def set_module(self, module) -> None:
        self.module = module

    def setup(self) -> None:
        if self.module is None:
            raise RuntimeError("call set_module(module) before setup()")
        if len(self.module.replay_buffer) == 0 and self.module.env is None:
            raise RuntimeError("an empty replay buffer needs an env to fill it: attach_env() first")

    def train_loader(self) -> _BufferLoader:
        return _BufferLoader(self.module, self.batch_size, self.steps_per_epoch, self.seed)

    def val_loader(self):
        return None
