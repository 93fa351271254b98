"""D4RL state-based datasets (port of tacorl_tpu/data/d4rl_dataset.py; the
port keeps its own copy: it imports nothing of the JAX package).

Window sampler over a d4rl-style dataset dict (observations / actions /
timeouts / terminals), with episode boundaries from the timeout/terminal
markers and the geometric xy-goal branch
(reference: datamodule/dataset/d4rl_play_dataset.py:15-251).

The dataset source is either the live ``gym.make(name).get_dataset()``
(requires the external d4rl package; the import is deferred and raises
without it) or an ``.npz`` file with the same keys, which also serves the
hermetic path (``generate_synthetic_d4rl``, ``generate_expert_d4rl``).

Every draw goes through the ``rng`` an item is given, in the JAX package's
order, so items (and the loader's batches) are bit-equal to the JAX
package's. ``_episode_end`` scans the episode list per item, as the JAX
package does: cheap at tens of episodes, visible in the loader's wait at
antmaze scale (about 1,000).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = [
    "load_d4rl_dataset",
    "generate_synthetic_d4rl",
    "generate_expert_d4rl",
    "D4RLPlayDataset",
    "D4RLTransitionDataset",
    "episode_bounds_from_markers",
]


def load_d4rl_dataset(
    d4rl_env: Optional[str] = None, dataset_path: Optional[str] = None
) -> Dict[str, np.ndarray]:
    if dataset_path is not None:
        with np.load(Path(dataset_path).expanduser()) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    try:
        import d4rl  # noqa: F401
        import gym
    except ImportError as e:
        raise ImportError(
            "d4rl/gym are required for live D4RL datasets; pass dataset_path "
            "to load from an .npz snapshot instead"
        ) from e
    return gym.make(d4rl_env).get_dataset()


def generate_synthetic_d4rl(
    path: Union[str, Path],
    n_steps: int = 600,
    episode_len: int = 100,
    obs_dim: int = 8,
    act_dim: int = 4,
    seed: int = 0,
) -> Path:
    """Random-walk 2D agent: obs[:2] is the xy position."""
    rs = np.random.RandomState(seed)
    actions = np.clip(rs.randn(n_steps, act_dim), -1, 1).astype(np.float32)
    obs = np.zeros((n_steps, obs_dim), dtype=np.float32)
    pos = np.zeros(2)
    for t in range(n_steps):
        if t % episode_len == 0:
            pos = rs.uniform(-1, 1, 2)
        pos = pos + 0.05 * actions[t, :2]
        obs[t, :2] = pos
        obs[t, 2:] = rs.randn(obs_dim - 2) * 0.1
    timeouts = np.zeros(n_steps, dtype=bool)
    timeouts[episode_len - 1 :: episode_len] = True
    terminals = np.zeros(n_steps, dtype=bool)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path, observations=obs, actions=actions, timeouts=timeouts,
        terminals=terminals, rewards=np.zeros(n_steps, dtype=np.float32),
    )
    return path


def generate_expert_d4rl(
    path: Union[str, Path],
    n_episodes: int = 40,
    legs_per_episode: int = 4,
    max_leg_steps: int = 60,
    obs_dim: int = 8,
    act_dim: int = 4,
    action_noise: float = 0.1,
    seed: int = 0,
) -> Path:
    """Expert play data on the FakeD4RLEnv dynamics: each episode walks the
    point-mass through ``legs_per_episode`` random waypoints with noisy
    goal-directed actions, so windows demonstrate goal-reaching at many
    distances. The kinematics mirror FakeD4RLEnv.step exactly
    (xy += 0.1 * clip(a[:2]), obs[2:] = 0.1 * randn), so behavior cloned
    from this data transfers to the env one-to-one."""
    rs = np.random.RandomState(seed)
    obs_rows: List[np.ndarray] = []
    act_rows: List[np.ndarray] = []
    timeout_rows: List[bool] = []
    for _ in range(n_episodes):
        pos = rs.uniform(-1.0, 0.0, 2)
        for _ in range(legs_per_episode):
            waypoint = rs.uniform(-1.2, 1.5, 2)
            for _ in range(max_leg_steps):
                obs = np.zeros(obs_dim, dtype=np.float32)
                obs[:2] = pos
                obs[2:] = 0.1 * rs.randn(obs_dim - 2)
                action = np.zeros(act_dim, dtype=np.float32)
                action[:2] = np.clip((waypoint - pos) / 0.1, -1, 1)
                action = np.clip(
                    action + rs.randn(act_dim).astype(np.float32) * action_noise, -1, 1,
                ).astype(np.float32)
                obs_rows.append(obs)
                act_rows.append(action)
                timeout_rows.append(False)
                pos = pos + 0.1 * np.clip(action[:2], -1, 1)
                if np.linalg.norm(pos - waypoint) < 0.15:
                    break
        timeout_rows[-1] = True
    n = len(obs_rows)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        observations=np.asarray(obs_rows, dtype=np.float32),
        actions=np.asarray(act_rows, dtype=np.float32),
        timeouts=np.asarray(timeout_rows, dtype=bool),
        terminals=np.zeros(n, dtype=bool),
        rewards=np.zeros(n, dtype=np.float32),
    )
    return path


def episode_bounds_from_markers(
    timeouts: np.ndarray, terminals: np.ndarray, min_len: int
) -> List[List[int]]:
    """Episode [start, end] spans from timeout/terminal markers
    (d4rl_play_dataset.py:212-224)."""
    ends = sorted(
        set(np.nonzero(timeouts)[0].tolist()) | set(np.nonzero(terminals)[0].tolist())
    )
    bounds, start = [], 0
    for end in ends:
        if end - start > min_len:
            bounds.append([start, int(end)])
        start = int(end) + 1
    return bounds


class D4RLPlayDataset:
    """Padded play windows of ``min_window_size``..``max_window_size``
    steps, with a geometric future xy goal and its reached flag when
    ``include_goal``."""

    def __init__(
        self,
        d4rl_env: Optional[str] = None,
        dataset_path: Optional[str] = None,
        min_window_size: int = 8,
        max_window_size: int = 16,
        pad: bool = True,
        include_goal: bool = False,
        goal_sampling_prob: float = 0.3,
        goal_augmentation: bool = False,
        goal_threshold: float = 0.5,
        train: bool = True,
        **_,
    ):
        self.dataset = load_d4rl_dataset(d4rl_env, dataset_path)
        self.min_window_size = min_window_size
        self.max_window_size = max_window_size
        self.pad = pad
        self.include_goal = include_goal
        self.goal_sampling_prob = goal_sampling_prob
        self.goal_augmentation = goal_augmentation
        self.goal_threshold = goal_threshold
        self.ep_start_end_ids = episode_bounds_from_markers(
            self.dataset["timeouts"], self.dataset["terminals"], min_window_size
        )
        self.episode_lookup = self._build_lookup()

    def _build_lookup(self) -> np.ndarray:
        lookup: List[int] = []
        for start, end in self.ep_start_end_ids:
            assert end > self.max_window_size
            lookup.extend(range(start, end + 1 - self.max_window_size))
        return np.asarray(lookup, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.episode_lookup)

    def _episode_end(self, step: int) -> Optional[int]:
        for start, end in self.ep_start_end_ids:
            if start <= step <= end:
                return end
        return None

    def sample(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        if self.min_window_size == self.max_window_size:
            ws = self.max_window_size
        else:
            ws = int(rng.integers(self.min_window_size, self.max_window_size + 1))
        start = int(self.episode_lookup[idx])
        obs = self.dataset["observations"][start : start + ws].astype(np.float32)
        actions = self.dataset["actions"][start : start + ws].astype(np.float32)
        if self.pad and ws < self.max_window_size:
            pad = self.max_window_size - ws
            obs = np.concatenate([obs, np.repeat(obs[-1:], pad, axis=0)])
            actions = np.concatenate([actions, np.zeros((pad, actions.shape[-1]), actions.dtype)])
        item = {
            "observations": obs,
            "actions": actions,
            "idx": np.int64(idx),
            "window_size": np.int64(ws),
        }
        if self.include_goal:
            item["goal"], item["goal_reached"] = self._future_goal(idx, ws, rng)
        return item

    def _goal_from_obs(self, obs_vec: np.ndarray, rng) -> np.ndarray:
        goal = obs_vec[:2].astype(np.float32).copy()
        if self.goal_augmentation:
            goal += rng.uniform(-0.1, 0.1, 2).astype(np.float32)
        return goal

    def _future_goal(self, idx: int, ws: int, rng) -> Tuple[np.ndarray, np.bool_]:
        """Geometric future xy goal + reached flag
        (d4rl_play_dataset.py:124-146)."""
        seq_start = int(self.episode_lookup[idx])
        episode_end = self._episode_end(seq_start)
        if episode_end is None:
            goal_step = int(rng.choice(self.episode_lookup))
        else:
            disp = int(rng.geometric(self.goal_sampling_prob))
            goal_step = seq_start + (ws - 1) * disp
            if self.goal_augmentation:
                goal_step += int(rng.integers(0, 3)) - 1
            goal_step = min(episode_end, goal_step)
        goal = self._goal_from_obs(self.dataset["observations"][goal_step], rng)
        seq_end_pos = self.dataset["observations"][seq_start + ws - 1][:2]
        reached = np.bool_(np.linalg.norm(goal - seq_end_pos) < self.goal_threshold)
        return goal, reached


class D4RLTransitionDataset:
    """Goal-relabeled flat transitions for state-based CQL: observations are
    concat(obs, goal_xy); reward = done = [next_obs within goal_threshold]
    (the state-based counterpart of GoalCondTransitionDataset; geometric
    goals)."""

    def __init__(
        self,
        d4rl_env: Optional[str] = None,
        dataset_path: Optional[str] = None,
        goal_sampling_prob: float = 0.3,
        goal_threshold: float = 0.5,
        train: bool = True,
        **_,
    ):
        self.dataset = load_d4rl_dataset(d4rl_env, dataset_path)
        self.goal_sampling_prob = goal_sampling_prob
        self.goal_threshold = goal_threshold
        self.ep_start_end_ids = episode_bounds_from_markers(
            self.dataset["timeouts"], self.dataset["terminals"], 1
        )
        steps: List[int] = []
        for start, end in self.ep_start_end_ids:
            steps.extend(range(start, end))
        self.possible_steps = np.asarray(steps, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.possible_steps)

    def _episode_end(self, step: int) -> int:
        for start, end in self.ep_start_end_ids:
            if start <= step <= end:
                return end
        raise KeyError(step)

    def sample(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        step = int(self.possible_steps[idx])
        disp = int(rng.geometric(self.goal_sampling_prob))
        goal_step = min(self._episode_end(step), step + disp)
        goal = self.dataset["observations"][goal_step][:2].astype(np.float32)
        obs = self.dataset["observations"][step].astype(np.float32)
        next_obs = self.dataset["observations"][step + 1].astype(np.float32)
        reached = np.float32(np.linalg.norm(next_obs[:2] - goal) < self.goal_threshold)
        return {
            "observations": np.concatenate([obs, goal]),
            "actions": self.dataset["actions"][step].astype(np.float32),
            "next_observations": np.concatenate([next_obs, goal]),
            "rewards": reached,
            "terminals": reached,
        }
