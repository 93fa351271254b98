"""Saved-transition datasets (a copy of tacorl_tpu/data/saved_transitions.py;
reference: datamodule/dataset/replay_buffer_dataset.py:8-60,
offline_replay_buffer_dataset.py:8-55): replay buffers persisted as
``transition_%09d.npz`` files, read for offline training on recorded
interaction data. The last ``val_percentage`` of the sorted files are the
validation split."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

__all__ = ["SavedTransitionDataset"]


def _unbox(value: np.ndarray):
    """A dict observation is stored as a 0-d object array."""
    return value.item() if value.dtype == object else value


class SavedTransitionDataset:
    def __init__(
        self,
        data_dir: Union[str, Path],
        train: bool = True,
        val_percentage: float = 0.1,
        **_,
    ):
        self.data_dir = Path(data_dir).expanduser()
        files = sorted(self.data_dir.glob("transition_*.npz"))
        if not files:
            raise FileNotFoundError(f"no transition files in {self.data_dir}")
        n_val = int(len(files) * val_percentage)
        if n_val == 0:
            self.files = files
        else:
            self.files = files[:-n_val] if train else files[-n_val:]

    def __len__(self) -> int:
        return len(self.files)

    def sample(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        data = np.load(self.files[idx], allow_pickle=True)
        return {
            "observations": _unbox(data["state"]),
            "actions": np.asarray(data["action"], dtype=np.float32),
            "next_observations": _unbox(data["next_state"]),
            "rewards": np.float32(data["reward"]),
            "terminals": np.float32(data["done"]),
        }
