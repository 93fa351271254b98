"""Train-only datamodule for D4RL datasets (port of
tacorl_tpu/data/d4rl_datamodule.py; reference:
datamodule/d4rl_data_module.py:12-66). It has no validation split:
``val_loader`` returns None, and the trainer then fires
``on_validation_end`` with no val pass, where the D4RL rollout callback
scores the policy."""

from __future__ import annotations

from typing import Any, Dict, Optional

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.data.loader import DataLoader

__all__ = ["D4RLDataModule"]


class D4RLDataModule:
    def __init__(
        self,
        dataset: Dict[str, Any],
        batch_size: int = 64,
        train_percentage: float = 1.0,
        seed: int = 0,
        prefetch: int = 2,
        **_,
    ):
        self.dataset_cfg = dict(dataset)
        self.batch_size = batch_size
        self.train_percentage = train_percentage
        self.seed = seed
        self.prefetch = prefetch
        self.train_dataset = None
        self.statistics = None

    def setup(self) -> None:
        cfg = dict(self.dataset_cfg)
        cls = get_class(cfg.pop("_target_", "tacorl_tpu.data.d4rl_dataset.D4RLPlayDataset"))
        self.train_dataset = cls(train=True, **cfg)

    def train_loader(self) -> DataLoader:
        return DataLoader(
            self.train_dataset,
            batch_size=self.batch_size,
            shuffle=True,
            seed=self.seed,
            percentage=self.train_percentage,
            prefetch=self.prefetch,
        )

    def val_loader(self) -> Optional[DataLoader]:
        return None
