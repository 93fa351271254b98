"""Fake D4RL-style state env (point-mass navigation) and the gated real-env
maker (port of tacorl_tpu/envs/fake_d4rl.py, host-side numpy).

Mirrors the d4rl gym surface the reference eval path uses
(evaluation/rollout_manager_d4rl.py:66-104): vector observations with xy in
the first two dims, ``target_goal``, ``get_normalized_score``, and
``max_episode_steps``. Every draw comes from the env's own
``np.random.RandomState(seed)``, in the JAX package's order, so episodes
under the same actions are bit-equal to its env's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["FakeD4RLEnv", "make_d4rl_env"]


def make_d4rl_env(name: str):
    try:
        import d4rl  # noqa: F401
        import gym
    except ImportError as e:
        raise ImportError(
            "d4rl/gym are required for real D4RL envs; use FakeD4RLEnv for hermetic runs"
        ) from e
    return gym.make(name)


class FakeD4RLEnv:
    def __init__(
        self,
        obs_dim: int = 8,
        act_dim: int = 4,
        max_episode_steps: int = 60,
        goal_threshold: float = 0.5,
        seed: int = 0,
    ):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.max_episode_steps = max_episode_steps
        self._max_episode_steps = max_episode_steps  # d4rl-compatible alias
        self.goal_threshold = goal_threshold
        self._rng = np.random.RandomState(seed)
        self.target_goal = np.asarray([1.0, 1.0], dtype=np.float32)
        self.goal_locations = [self.target_goal]
        self._obs = np.zeros(obs_dim, dtype=np.float32)
        self._steps = 0

    @property
    def action_dim(self) -> int:
        return self.act_dim

    def reset(self) -> np.ndarray:
        self._steps = 0
        self._obs = np.zeros(self.obs_dim, dtype=np.float32)
        self._obs[:2] = self._rng.uniform(-1.0, 0.0, 2)
        self.target_goal = self._rng.uniform(0.5, 1.5, 2).astype(np.float32)
        self.goal_locations = [self.target_goal]
        return self._obs.copy()

    def step(self, action: np.ndarray) -> Tuple[np.ndarray, float, bool, dict]:
        action = np.clip(np.asarray(action, dtype=np.float32), -1, 1)
        self._obs[:2] += 0.1 * action[:2]
        self._obs[2:] = 0.1 * self._rng.randn(self.obs_dim - 2)
        self._steps += 1
        dist = float(np.linalg.norm(self._obs[:2] - self.target_goal))
        success = dist < self.goal_threshold
        reward = 1.0 if success else 0.0
        done = success or self._steps >= self.max_episode_steps
        return self._obs.copy(), reward, done, {"success": success}

    def get_normalized_score(self, episode_return: float) -> float:
        return float(episode_return)  # already in [0, 1] per episode

    def expert_action(self) -> np.ndarray:
        a = np.zeros(self.act_dim, dtype=np.float32)
        a[:2] = np.clip((self.target_goal - self._obs[:2]) / 0.1, -1, 1)
        return a
