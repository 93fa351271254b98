"""Goal-conditioned transition dataset for flat offline RL (a copy of
tacorl_tpu/data/transition_dataset.py; reference GoalCondReplayBufferDataset,
datamodule/dataset/goal_cond_replay_buffer_dataset.py:17-299): one item per
non-terminal step, seven goal-relabelling strategies, the horizon curriculum
hooks, the language-annotation task filter, and
reward = done = [goal == next step].

Items are raw frames (uint8 images, float vectors); transforms run on the
device. Every draw comes from the item's ``numpy.random.Generator`` in the
JAX package's order (the strategy, then the strategy's own draws), so the
loader's batches are bit-equal to the JAX loader's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tacorl_tpu_torch.data.knn import load_or_build_nn_index
from tacorl_tpu_torch.data.storage import load_ep_start_end_ids, open_storage

__all__ = ["GoalCondTransitionDataset"]


class GoalCondTransitionDataset:
    def __init__(
        self,
        data_dir: Union[str, Path],
        modalities: Sequence[str],
        action_type: str = "rel_actions_world",
        train: bool = True,
        goal_strategy_prob: Optional[Dict[str, float]] = None,
        initial_horizon: int = 8,
        horizon_step: int = 4,
        max_horizon: int = 256,
        nn_steps_from_step_path: str = "nn_steps_from_step.json",
        num_nn: int = 32,
        filter_by_tasks: bool = False,
        tasks: Sequence[str] = (),
        goal_sampling_prob: float = 0.3,
        **_,
    ):
        modalities = list(modalities)
        if action_type not in modalities:
            raise ValueError(f"{action_type} must be in modalities")
        self.modalities = modalities
        self.action_type = action_type
        self.train = train
        self.data_dir = Path(data_dir)
        self.storage = open_storage(self.data_dir)
        self.ep_start_end_ids = load_ep_start_end_ids(self.data_dir, train)
        probs = goal_strategy_prob or {"geometric": 0.5, "similar_robot_obs": 0.5}
        # a config-group merge can only zero an inherited strategy, not
        # delete its key; a zero strategy is dropped so that it costs no
        # set-up (the similar_robot_obs k-NN index)
        self.goal_strategy_prob = {k: float(v) for k, v in probs.items() if v > 0}
        if not np.isclose(sum(self.goal_strategy_prob.values()), 1.0):
            raise ValueError(f"goal strategy probabilities must sum to 1: {probs}")
        self.initial_horizon = initial_horizon
        self.current_horizon = initial_horizon
        self.horizon_step = horizon_step
        self.max_horizon = max_horizon
        self.goal_sampling_prob = goal_sampling_prob

        if "task_future" in self.goal_strategy_prob or filter_by_tasks:
            self._load_lang_ann()
        self._set_possible_steps(filter_by_tasks, list(tasks))
        if "similar_robot_obs" in self.goal_strategy_prob:
            nn_path = Path(nn_steps_from_step_path).expanduser()
            if not nn_path.is_absolute():
                nn_path = self.data_dir / nn_path
            self.nn_steps_from_step = load_or_build_nn_index(
                nn_path,
                "train" if train else "validation",
                steps=self.possible_steps,
                vectors_fn=self._robot_obs_matrix,
                num_nn=num_nn,
            )

    def __len__(self) -> int:
        return len(self.possible_steps)

    # -- construction ------------------------------------------------------

    def _load_lang_ann(self) -> None:
        path = self.data_dir / "lang_annotations/auto_lang_ann.npy"
        if not path.is_file():
            raise FileNotFoundError(f"language annotation file not found: {path}")
        self.lang_ann = np.load(path, allow_pickle=True).item()

    def _set_possible_steps(self, filter_by_tasks: bool, tasks: List[str]) -> None:
        """Every step but an episode's last (goal_cond_replay_buffer_dataset.py:
        174-186), optionally only inside the annotated spans of ``tasks``."""
        steps: List[int] = []
        for start, end in self.ep_start_end_ids:
            steps.extend(range(start, end))
        steps.sort()
        if filter_by_tasks:
            task_steps: List[int] = []
            for i, task in enumerate(self.lang_ann["language"]["task"]):
                if task in tasks:
                    s, e = self.lang_ann["info"]["indx"][i]
                    task_steps.extend(range(s, e + 1))
            steps = sorted(set(steps) & set(task_steps))
        self.possible_steps = steps

    def _robot_obs_matrix(self) -> np.ndarray:
        return np.stack(
            [self.storage.read_frame(s, ["robot_obs"])["robot_obs"] for s in self.possible_steps]
        ).astype(np.float32)

    # -- curriculum hooks ----------------------------------------------------

    def increase_horizon(self, epoch: int) -> None:
        self.current_horizon = min(self.initial_horizon + epoch * self.horizon_step, self.max_horizon)

    def increase_horizon_to(self, desired: int) -> None:
        self.current_horizon = min(desired, self.max_horizon)

    # -- goal strategies -----------------------------------------------------

    def _episode_end(self, step: int) -> Optional[int]:
        for start, end in self.ep_start_end_ids:
            if start <= step <= end:
                return int(end)
        return None

    def _task_end(self, step: int) -> Optional[int]:
        for i, _task in enumerate(self.lang_ann["language"]["task"]):
            s, e = self.lang_ann["info"]["indx"][i]
            if s <= step <= e:
                return int(e)
        return None

    @staticmethod
    def _random_future(rng, start: Optional[int], end: Optional[int]) -> Optional[int]:
        if start is None or end is None or start >= end + 1:
            return None
        return int(rng.integers(start, end + 1))

    def get_goal_step(self, rng, step: int, strategy: str = "random") -> int:
        """The seven strategies of goal_cond_replay_buffer_dataset.py:224-264;
        a strategy with no goal to offer falls back as the JAX package's
        does."""
        if strategy == "random":
            goal = step
            while goal == step:
                goal = int(rng.choice(self.possible_steps))
            return goal
        if strategy == "geometric":
            episode_end = self._episode_end(step)
            disp = int(rng.geometric(p=self.goal_sampling_prob))
            return min(episode_end, step + disp)
        if strategy == "increasing_horizon":
            end = min(self._episode_end(step), step + self.current_horizon)
            goal = self._random_future(rng, step + 1, end)
            return goal if goal is not None else self.get_goal_step(rng, step, "random")
        if strategy == "similar_robot_obs":
            options = self.nn_steps_from_step.get(step, [])
            if not options:
                return self.get_goal_step(rng, step, "random")
            return int(rng.choice(options))
        if strategy == "next_state":
            return step + 1
        if strategy == "episode_future":
            goal = self._random_future(rng, step + 1, self._episode_end(step))
            return goal if goal is not None else self.get_goal_step(rng, step, "random")
        if strategy == "task_future":
            goal = self._random_future(rng, step + 1, self._task_end(step))
            return goal if goal is not None else self.get_goal_step(rng, step, "episode_future")
        raise ValueError(f"unknown goal strategy {strategy!r}")

    # -- sampling ------------------------------------------------------------

    def _state_keys(self) -> List[str]:
        return [m for m in self.modalities if m != self.action_type]

    def sample(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        step = self.possible_steps[idx]
        frame = self.storage.read_frame(step, self.modalities)
        action = frame.pop(self.action_type)
        obs = {k: frame[k] for k in self._state_keys()}
        next_obs = self.storage.read_frame(step + 1, self._state_keys())
        strategy = rng.choice(
            list(self.goal_strategy_prob.keys()), p=list(self.goal_strategy_prob.values())
        )
        goal_step = self.get_goal_step(rng, step, strategy)
        goal = self.storage.read_frame(goal_step, self._state_keys())
        reached = np.float32(goal_step == step + 1)
        return {
            "observations": {"observation": obs, "goal": goal},
            "actions": np.asarray(action, dtype=np.float32),
            "next_observations": {"observation": next_obs, "goal": goal},
            "rewards": reached,
            "terminals": reached,
        }
