"""Parallel env stepping for the replay buffer's warm fill (a copy of
tacorl_tpu/envs/vec_env.py; reference: SubprocVecEnv usage in
sac_lightning.py:297-350).

PyBullet instances are process-bound in the reference, forcing subprocesses;
the fake and state envs are plain Python, so a thread pool suffices. API:
reset() -> list[obs], step(actions) -> (list[obs], rewards, dones, infos);
a done env auto-resets, with its final observation in
``info["terminal_observation"]`` (SubprocVecEnv semantics). ``pool.map``
keeps the order of the envs, so the results are those of stepping the envs
one after another."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Sequence

import numpy as np

__all__ = ["ThreadedVecEnv"]


class ThreadedVecEnv:
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self._pool = ThreadPoolExecutor(max_workers=len(self.envs))

    def __len__(self) -> int:
        return len(self.envs)

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    def reset(self) -> List[Any]:
        return list(self._pool.map(lambda e: e.reset(), self.envs))

    def step(self, actions: Sequence[np.ndarray]):
        def one(pair):
            env, action = pair
            obs, reward, done, info = env.step(action)
            if done:
                info = dict(info)
                info["terminal_observation"] = obs
                obs = env.reset()
            return obs, reward, done, info

        results = list(self._pool.map(one, zip(self.envs, actions)))
        obs, rewards, dones, infos = zip(*results)
        return list(obs), np.asarray(rewards), np.asarray(dones), list(infos)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
