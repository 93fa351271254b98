"""Real-robot (Franka Panda via robot_io) environment adapter (port of
tacorl_tpu/envs/real_world.py; reference: envs/real_world.py:10-79).

robot_io is hardware-bound and not a dependency; the import is deferred to
construction. Action scaling and the goal-injected reset mirror the
reference exactly (MAX_REL_POS/ORN :6-7; reset paths :22-43). Observations
and actions are numpy, as the rollout managers hand them over."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

MAX_REL_POS = 0.02
MAX_REL_ORN = 0.05

__all__ = ["RealWorldEnv", "MAX_REL_POS", "MAX_REL_ORN"]


class RealWorldEnv:
    def __init__(
        self,
        modalities: Sequence[str] = ("rgb_static",),
        max_episode_steps: int = 500,
        robot=None,
        **robot_env_kwargs,
    ):
        try:
            from robot_io.envs.robot_env import RobotEnv
        except ImportError as e:  # pragma: no cover - hardware dep
            raise ImportError(
                "robot_io is required for the real-robot environment "
                "(github.com/mees/robot_io)"
            ) from e
        self._env = RobotEnv(robot=robot, **robot_env_kwargs)
        self.modalities = list(modalities)
        self.max_episode_steps = max_episode_steps
        self.goal: Optional[Dict[str, np.ndarray]] = None

    def reset(
        self,
        goal: Dict[str, np.ndarray],
        robot_obs: Optional[np.ndarray] = None,
        reset_to_neutral: bool = False,
        **kwargs,
    ):
        assert goal is not None, "goal must not be empty"
        self.goal = goal
        if reset_to_neutral:
            self._env.reset(**kwargs)
            return self.get_obs()
        if robot_obs is not None:
            self._env.reset(
                target_pos=robot_obs[:3],
                target_orn=robot_obs[3:6],
                gripper_state="open" if robot_obs[-1] == 1 else "closed",
                **kwargs,
            )
        return self.get_obs()

    def get_obs(self) -> Dict:
        obs = self._env.camera_manager.get_images()
        obs["robot_obs"] = self._env.robot.get_state()
        filtered = {m: np.asarray(obs[m]).copy() for m in self.modalities}
        return {"observation": filtered, "goal": self.goal}

    def step(self, action: np.ndarray):
        action = np.clip(np.asarray(action, dtype=np.float64), -1.0, 1.0)
        robot_action = {
            "motion": (
                action[:3] * MAX_REL_POS,
                action[3:6] * MAX_REL_ORN,
                1 if action[-1] > 0 else -1,
            ),
            "ref": "rel",
        }
        _obs, reward, done, info = self._env.step(robot_action)
        info.setdefault("success", False)
        return self.get_obs(), reward, done, info
