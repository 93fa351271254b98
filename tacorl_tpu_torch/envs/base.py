"""Environment interface (a copy of tacorl_tpu/envs/base.py).

Host-side gym-style API matching the reference env layer's
surface (envs/rl_base_env.py:141-205, envs/goal_conditioned_env.py:136-206):

    obs = env.reset(robot_obs=..., scene_obs=...)        # state reset
    obs = env.reset(task_info={"start_info": .., "goal_info": .., "tasks": ..})
    obs, reward, done, info = env.step(action)           # info["success"],
                                                         # info["successful_tasks"]

Observations are dicts {"observation": {modality: np.ndarray}, "goal": {...}}.
The policy side never sees the env — rollout managers bridge the two.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["GoalConditionedEnvBase"]


class GoalConditionedEnvBase:
    max_episode_steps: int = 180
    modalities: Tuple[str, ...] = ("rgb_static",)
    goal_modalities: Tuple[str, ...] = ("rgb_static",)

    # -- required ----------------------------------------------------------

    def reset(
        self,
        robot_obs: Optional[np.ndarray] = None,
        scene_obs: Optional[np.ndarray] = None,
        task_info: Optional[dict] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self, action: np.ndarray):
        raise NotImplementedError

    def get_obs(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- shared ------------------------------------------------------------

    @property
    def action_dim(self) -> int:
        return 7

    def get_info(self) -> Dict[str, Any]:
        raise NotImplementedError
