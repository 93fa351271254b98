"""Rollout task generators (a copy of tacorl_tpu/evaluation/
rollout_generator.py): parse ``start_end_tasks.json``
({start_idx: {end_idx: [completed tasks]}}) into evaluation task lists
(reference: evaluation/rollout_generator.py:11-242).

Three shapes:
  * SingleTaskRolloutGenerator — per-task single rollouts with seq-len filter
  * LongHorizonRolloutGenerator — N-task chains with one final goal image
  * LongHorizonSequentialRolloutGenerator — chains with intermediate goals,
    requiring monotonically increasing completed-task counts
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from tacorl_tpu_torch.data.storage import open_storage

__all__ = [
    "SingleTaskRolloutGenerator",
    "LongHorizonRolloutGenerator",
    "LongHorizonSequentialRolloutGenerator",
]


class BaseRolloutGenerator:
    def __init__(
        self,
        data_dir: Union[str, Path],
        start_end_tasks: Union[str, Path],
        strategy: str = "longest",
        min_seq_len: int = 16,
        max_seq_len: int = 64,
        seed: int = 0,
    ):
        self.min_seq_len = min_seq_len
        self.max_seq_len = max_seq_len
        self.data_dir = Path(data_dir).expanduser()
        self.storage = open_storage(self.data_dir)
        self._rng = np.random.RandomState(seed)
        path = Path(start_end_tasks).expanduser()
        with open(path) as f:
            table = json.load(f)
        self.rollout_tasks = self.build_rollout_tasks(table)
        self.order_rollouts(strategy)

    # -- per-step state access -------------------------------------------------

    def get_state_from_step(self, step: int, modalities=("rgb_static",)) -> Dict:
        return self.storage.read_frame(int(step), list(modalities))

    def get_state_info_from_step(self, step: int) -> Dict:
        return self.storage.read_frame(int(step), ["robot_obs", "scene_obs"])

    # -- overridables -------------------------------------------------------------

    def build_rollout_tasks(self, table: dict):
        raise NotImplementedError

    def order_rollouts(self, strategy: str) -> None:
        raise NotImplementedError

    def get_rollout_tasks(self):
        return self.rollout_tasks

    def _sort(self, items: List[dict], strategy: str) -> List[dict]:
        if strategy == "shortest":
            return sorted(items, key=lambda d: d["seq_len"])
        if strategy == "longest":
            return sorted(items, key=lambda d: d["seq_len"], reverse=True)
        if strategy == "random":
            items = list(items)
            self._rng.shuffle(items)
            return items
        return items


class SingleTaskRolloutGenerator(BaseRolloutGenerator):
    """{task: [{start_step, end_step, seq_len}, ...]} for single-task spans
    inside (min_seq_len, max_seq_len) (rollout_generator.py:84-134)."""

    def build_rollout_tasks(self, table: dict) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for start_idx, end_tasks in table.items():
            for end_idx, completed in end_tasks.items():
                if len(completed) != 1:
                    continue
                seq_len = int(end_idx) - int(start_idx)
                if not (self.max_seq_len > seq_len > self.min_seq_len):
                    continue
                out.setdefault(completed[0], []).append(
                    {
                        "start_step": int(start_idx),
                        "end_step": int(end_idx),
                        "seq_len": seq_len,
                    }
                )
        return out

    def order_rollouts(self, strategy: str) -> None:
        for task in self.rollout_tasks:
            self.rollout_tasks[task] = self._sort(
                self.rollout_tasks[task], strategy
            )

    def get_num_rollouts_from_task(self, task: str) -> int:
        return len(self.rollout_tasks[task])

    def get_rollout_task(self, task: str, task_idx: int) -> dict:
        return self.rollout_tasks[task][task_idx]

    def get_reset_info(self, task: str, task_idx: int) -> dict:
        rt = self.rollout_tasks[task][task_idx]
        return {
            "task_info": {
                "start_info": self.get_state_info_from_step(rt["start_step"]),
                "goal_info": self.get_state_info_from_step(rt["end_step"]),
                "tasks": [task],
            }
        }


class LongHorizonRolloutGenerator(BaseRolloutGenerator):
    """Flat list of spans whose completed-task count == tasks_per_rollout
    (rollout_generator.py:137-178)."""

    def __init__(self, tasks_per_rollout: int = 4, **kwargs):
        self.tasks_per_rollout = tasks_per_rollout
        super().__init__(**kwargs)

    def build_rollout_tasks(self, table: dict) -> List[dict]:
        out = []
        for start_idx, end_tasks in table.items():
            for end_idx, completed in end_tasks.items():
                if len(completed) == self.tasks_per_rollout:
                    out.append(
                        {
                            "start_step": int(start_idx),
                            "end_step": int(end_idx),
                            "seq_len": int(end_idx) - int(start_idx),
                            "completed_tasks": list(completed),
                        }
                    )
        return out

    def order_rollouts(self, strategy: str) -> None:
        self.rollout_tasks = self._sort(self.rollout_tasks, strategy)

    def get_reset_info(self, task_idx: int) -> dict:
        rt = self.rollout_tasks[task_idx]
        return {
            "task_info": {
                "start_info": self.get_state_info_from_step(rt["start_step"]),
                "goal_info": self.get_state_info_from_step(rt["end_step"]),
                "tasks": rt["completed_tasks"],
            }
        }


class LongHorizonSequentialRolloutGenerator(BaseRolloutGenerator):
    """{start_idx: OrderedDict{end_idx: completed}} chains where the
    completed-task count increases by one at each end index
    (rollout_generator.py:181-242)."""

    def __init__(self, tasks_per_rollout: int = 5, **kwargs):
        self.tasks_per_rollout = tasks_per_rollout
        super().__init__(**kwargs)

    def build_rollout_tasks(self, table: dict) -> "OrderedDict":
        filtered: "OrderedDict" = OrderedDict()
        for start_idx, end_tasks in table.items():
            sorted_ends = sorted(int(k) for k in end_tasks)[
                : self.tasks_per_rollout
            ]
            counter = 1
            entry: "OrderedDict" = OrderedDict()
            for end_idx in sorted_ends:
                completed = end_tasks[str(end_idx)]
                if len(completed) != counter:
                    break
                entry[end_idx] = completed
                counter += 1
                if len(completed) == self.tasks_per_rollout:
                    filtered[start_idx] = entry
                    break
        return filtered

    def order_rollouts(self, strategy: str) -> None:
        def chain_len(item):
            start, entry = item
            return next(reversed(entry)) - int(start)

        items = list(self.rollout_tasks.items())
        if strategy == "shortest":
            items.sort(key=chain_len)
        elif strategy == "longest":
            items.sort(key=chain_len, reverse=True)
        elif strategy == "random":
            self._rng.shuffle(items)
        self.rollout_tasks = OrderedDict(items)
