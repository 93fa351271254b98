"""Data module: directory discovery + train/val dataset/loader wiring (port
of tacorl_tpu/data/datamodule.py; reference:
datamodule/basic_data_module.py:17-158). Dataset targets name
``tacorl_tpu.X`` classes and resolve to the port's (``config.get_class``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.data.loader import DataLoader
from tacorl_tpu_torch.data.storage import load_statistics

__all__ = ["BasicDataModule"]


class BasicDataModule:
    def __init__(
        self,
        data_dir: str,
        dataset: Dict[str, Any],
        batch_size: int = 32,
        train_percentage: float = 1.0,
        val_percentage: float = 1.0,
        shuffle_val: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        **_: Any,
    ):
        self.data_path = Path(data_dir).expanduser()
        self.dataset_cfg = dict(dataset)
        self.batch_size = batch_size
        self.train_percentage = train_percentage
        self.val_percentage = val_percentage
        self.shuffle_val = shuffle_val
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last

        # directory discovery (basic_data_module.py:45-54)
        self.split_by_file = False
        if (self.data_path / "training").is_dir():
            self.training_dir = self.data_path / "training"
            self.val_dir = self.data_path / "validation"
        elif (self.data_path / "split.json").is_file():
            self.split_by_file = True
            self.training_dir = self.val_dir = self.data_path
        else:
            raise FileNotFoundError(
                f"no training/validation partition inside {self.data_path}"
            )
        self.statistics = load_statistics(self.training_dir)
        self.train_dataset = None
        self.val_dataset = None

    def setup(self) -> None:
        cfg = dict(self.dataset_cfg)
        cls = get_class(
            cfg.pop("_target_", "tacorl_tpu.data.play_dataset.PlayWindowDataset")
        )
        self.train_dataset = cls(data_dir=self.training_dir, train=True, **cfg)
        if self.val_percentage > 0:
            self.val_dataset = cls(data_dir=self.val_dir, train=False, **cfg)

    def train_loader(self) -> DataLoader:
        return DataLoader(
            self.train_dataset,
            batch_size=self.batch_size,
            shuffle=True,
            seed=self.seed,
            percentage=self.train_percentage,
            prefetch=self.prefetch,
            drop_last=self.drop_last,
        )

    def val_loader(self) -> Optional[DataLoader]:
        if self.val_dataset is None:
            return None
        return DataLoader(
            self.val_dataset,
            batch_size=self.batch_size,
            shuffle=self.shuffle_val,
            seed=self.seed,
            percentage=self.val_percentage,
            prefetch=self.prefetch,
            drop_last=self.drop_last,
        )
