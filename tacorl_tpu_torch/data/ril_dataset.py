"""Relay-imitation-learning dataset (a copy of tacorl_tpu/data/ril_dataset.py;
reference: datamodule/dataset/relay_imitation_learning_dataset.py:21-206):
one item per step, with a low-level goal at most ``max_low_level_window``
steps ahead and a high-level goal at most ``max_high_level_window`` ahead
inside the step's episode; the high level's target ("action") is the frame
at the end of the low-level window.

Items are raw frames (uint8 images, float vectors); transforms run on the
device. Each item draws from its ``numpy.random.Generator`` in the JAX
package's order (the low-level goal, then the high-level one), so the
loader's batches are bit-equal to the JAX loader's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tacorl_tpu_torch.data.storage import load_ep_start_end_ids, open_storage

__all__ = ["RILDataset"]


class RILDataset:
    def __init__(
        self,
        data_dir: Union[str, Path],
        modalities: Sequence[str],
        action_type: str = "rel_actions_world",
        train: bool = True,
        max_low_level_window: int = 30,
        max_high_level_window: int = 260,
        **_,
    ):
        modalities = list(modalities)
        if action_type not in modalities:
            raise ValueError(f"{action_type} must be in modalities")
        self.modalities = modalities
        self.action_type = action_type
        self.data_dir = Path(data_dir)
        self.storage = open_storage(self.data_dir)
        self.ep_start_end_ids = load_ep_start_end_ids(self.data_dir, train)
        self.max_low_level_window = max_low_level_window
        self.max_high_level_window = max_high_level_window
        self.episode_lookup = self._build_lookup()

    def _build_lookup(self) -> np.ndarray:
        steps: List[int] = []
        for start, end in self.ep_start_end_ids:
            steps.extend(range(start, end))
        return np.asarray(steps, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.episode_lookup)

    def _episode_end(self, step: int) -> int:
        """The end of the first episode that holds ``step`` (a linear scan,
        as the JAX package does)."""
        for start, end in self.ep_start_end_ids:
            if start <= step <= end:
                return int(end)
        raise KeyError(step)

    @staticmethod
    def _sample_goal_step(rng, start: int, end: int) -> int:
        """A step in [start, end); ``end`` itself, without a draw, when the
        range is empty."""
        if end <= start:
            return end
        return int(rng.integers(start, end))

    def _state_keys(self) -> List[str]:
        return [m for m in self.modalities if m != self.action_type]

    def sample(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        step = int(self.episode_lookup[idx])
        ep_end = self._episode_end(step)

        ll_max_end = min(ep_end, step + self.max_low_level_window)
        ll_goal_step = self._sample_goal_step(rng, step + 1, ll_max_end)
        frame = self.storage.read_frame(step, self.modalities)
        action = frame.pop(self.action_type)
        obs = {k: frame[k] for k in self._state_keys()}
        ll_goal = self.storage.read_frame(ll_goal_step, self._state_keys())

        hl_max_end = min(ep_end, step + self.max_high_level_window)
        hl_goal_step = self._sample_goal_step(rng, ll_max_end, hl_max_end)
        hl_goal = self.storage.read_frame(hl_goal_step, self._state_keys())
        subgoal = self.storage.read_frame(ll_max_end, self._state_keys())

        return {
            "obs": obs,
            "low_level_goal": ll_goal,
            "low_level_action": np.asarray(action, dtype=np.float32),
            "high_level_goal": hl_goal,
            "high_level_action": subgoal,
        }
