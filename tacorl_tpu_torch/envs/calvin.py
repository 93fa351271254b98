"""Real CALVIN (PyBullet) environment adapter (a copy of
tacorl_tpu/envs/calvin.py, host-side numpy).

Capability parity with the reference env layer over calvin_env
(envs/rl_base_env.py:15-225, envs/goal_conditioned_env.py:15-206,
envs/play_table_env.py:11-102): modality-driven observation assembly, the
three action frames (abs / rel_world / rel_tcp), discrete gripper, the
apply-until-TCP-converges micro-repeat loop, goal-image resets from complete
or goal-only state info, and success = selected tasks ⊆ achieved via the
CALVIN task differ. Every numpy call is the JAX package's, in its order, so
under the same simulator the two adapters step bit-equal.

calvin_env (and PyBullet) are external dependencies that need not be
installed: the import is deferred to construction, which raises a clear
ImportError without them, and the port's FakeCalvinEnv keeps the whole
evaluation and training stack runnable without them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tacorl_tpu_torch.envs.base import GoalConditionedEnvBase
from tacorl_tpu_torch.utils.geometry import to_world_frame

__all__ = ["CalvinGoalConditionedEnv", "CalvinPlayTableEnv"]


def _require_calvin():
    try:
        from calvin_env.envs.play_table_env import PlayTableSimEnv  # noqa: F401

        return PlayTableSimEnv
    except ImportError as e:  # pragma: no cover - external dep
        raise ImportError(
            "calvin_env is required for the real CALVIN environment; install "
            "it (github.com/mees/calvin_env) or use "
            "tacorl_tpu_torch.envs.fake_calvin.FakeCalvinEnv"
        ) from e


class CalvinGoalConditionedEnv(GoalConditionedEnvBase):
    def __init__(
        self,
        modalities: Sequence[str] = ("rgb_static",),
        goal_modalities: Sequence[str] = ("rgb_static",),
        max_episode_steps: int = 180,
        action_type: str = "rel_world",
        tasks: Optional[Any] = None,
        initial_and_goal_states: Optional[dict] = None,
        **sim_kwargs,
    ):
        PlayTableSimEnv = _require_calvin()
        self.sim = PlayTableSimEnv(**sim_kwargs)
        self.modalities = tuple(modalities)
        self.goal_modalities = tuple(goal_modalities)
        self.max_episode_steps = max_episode_steps
        self.action_type = action_type
        self.initial_and_goal_states = initial_and_goal_states or {}
        if tasks is None:
            from calvin_env.envs.tasks import Tasks  # pragma: no cover

            tasks = Tasks()
        self.tasks = tasks
        self.selected_tasks: List[str] = []
        self.goal: Optional[Dict[str, np.ndarray]] = None
        self.start_info: Dict[str, Any] = {}
        self._steps = 0

    # -- observation assembly (rl_base_env.py:84-123) --------------------------

    def _camera_obs(self, modalities) -> Dict[str, np.ndarray]:
        obs = {}
        for cam in self.sim.cameras:
            rgb_name, depth_name = f"rgb_{cam.name}", f"depth_{cam.name}"
            if rgb_name in modalities or depth_name in modalities:
                rgb, depth = cam.render()
                if rgb_name in modalities:
                    obs[rgb_name] = rgb
                if depth_name in modalities:
                    obs[depth_name] = depth
        return obs

    def _state_obs(self, modalities) -> Dict[str, np.ndarray]:
        obs = self._camera_obs(modalities)
        if "scene_obs" in modalities:
            obs["scene_obs"] = self.sim.scene.get_obs()
        if "robot_obs" in modalities:
            robot_obs, _info = self.sim.robot.get_observation()
            obs["robot_obs"] = np.asarray(robot_obs)
        return obs

    def get_obs(self) -> Dict[str, Any]:
        return {
            "observation": self._state_obs(self.modalities),
            "goal": self.goal,
        }

    def get_info(self) -> Dict[str, Any]:
        return self.sim.get_info()

    def get_state_obs(self) -> Dict[str, np.ndarray]:
        robot_obs, _ = self.sim.robot.get_observation()
        return {
            "robot_obs": np.asarray(robot_obs),
            "scene_obs": self.sim.scene.get_obs(),
        }

    # -- reset (goal_conditioned_env.py:43-157) ----------------------------------

    def _sim_reset(self, robot_obs=None, scene_obs=None):
        return self.sim.reset(robot_obs=robot_obs, scene_obs=scene_obs)

    def reset(
        self,
        robot_obs=None,
        scene_obs=None,
        task_info: Optional[dict] = None,
        **kwargs,
    ):
        self._steps = 0
        if robot_obs is not None or scene_obs is not None:
            self.selected_tasks = []
            self.goal = None
            self._sim_reset(robot_obs, scene_obs)
            self.start_info = self.get_info()
            return self.get_obs()
        if task_info is not None:
            return self._set_tasks(task_info)
        # random stored task configuration (goal_conditioned_env.py:151-157)
        task = np.random.choice(list(self.initial_and_goal_states))
        index = np.random.choice(len(self.initial_and_goal_states[task]))
        return self._set_tasks({"task": task, "index": int(index)})

    def _set_tasks(self, task_info: dict):
        if "index" in task_info:
            entry = self.initial_and_goal_states[task_info["task"]][
                task_info["index"]
            ]
            self.selected_tasks = [task_info["task"]]
            self._sim_reset(
                np.asarray(entry["goal"]["robot_obs"]),
                np.asarray(entry["goal"]["scene_obs"]),
            )
            self.goal = self._state_obs(self.goal_modalities)
            self._sim_reset(
                np.asarray(entry["initial"]["robot_obs"]),
                np.asarray(entry["initial"]["scene_obs"]),
            )
            self.start_info = self.get_info()
            return self.get_obs()

        tasks = task_info.get("tasks") or []
        goal_info = task_info["goal_info"]
        if task_info.get("start_info") is not None:
            self._sim_reset(**goal_info)
            self.goal = self._state_obs(self.goal_modalities)
            end_info = self.get_info()
            self._sim_reset(**task_info["start_info"])
        else:
            curr = self.get_state_obs()
            self._sim_reset(**goal_info)
            self.goal = self._state_obs(self.goal_modalities)
            end_info = self.get_info()
            self._sim_reset(**curr)
        self.start_info = self.get_info()
        if tasks:
            self.selected_tasks = list(tasks)
        else:
            self.selected_tasks = list(
                self.tasks.get_task_info(self.start_info, end_info)
            )
        return self.get_obs()

    # -- step (rl_base_env.py:141-205) ---------------------------------------------

    def step(self, action: np.ndarray):
        action = np.asarray(action, dtype=np.float64).reshape(-1)
        env_action = action.copy()
        env_action[-1] = (int(action[-1] >= 0) * 2) - 1  # discrete gripper

        robot = self.sim.robot
        _, robot_info = robot.get_observation()
        if self.action_type == "abs":
            abs_action = env_action
        elif self.action_type == "rel_world":
            abs_action = robot.relative_to_absolute(env_action)
        elif self.action_type == "rel_tcp":
            pos_w, orn_w = to_world_frame(
                env_action[:3] * robot.max_rel_pos,
                env_action[3:6] * robot.max_rel_orn,
                robot_info["tcp_orn"],
            )
            rel_world = np.concatenate(
                [pos_w / robot.max_rel_pos, orn_w / robot.max_rel_orn, env_action[6:]]
            )
            abs_action = robot.relative_to_absolute(rel_world)
        else:
            raise ValueError(f"unknown action_type {self.action_type!r}")

        # micro-repeat until the TCP converges (<=4 applications)
        curr_pos = np.asarray(robot_info["tcp_pos"])
        last_pos = np.asarray(abs_action[0])
        applied = 0
        while applied == 0 or (
            applied < 4
            and np.linalg.norm(np.asarray(abs_action[0]) - curr_pos) > 0.005
            and np.linalg.norm(last_pos - curr_pos) > 0.005
        ):
            robot.apply_action(abs_action)
            for _ in range(self.sim.action_repeat):
                self.sim.p.stepSimulation(physicsClientId=self.sim.cid)
            last_pos = curr_pos
            _, robot_info = robot.get_observation()
            curr_pos = np.asarray(robot_info["tcp_pos"])
            applied += 1

        self.sim.scene.step()
        self._steps += 1
        reward, r_info = self._reward()
        success = self._success()
        done = success or self._steps >= self.max_episode_steps
        info = self.get_info()
        info.update(r_info)
        info["success"] = success
        return self.get_obs(), reward, done, info

    # -- success / reward (goal_conditioned_env.py:184-206) -------------------------

    def get_successful_tasks(self) -> List[str]:
        return sorted(
            self.tasks.get_task_info_for_set(
                self.start_info, self.get_info(), self.selected_tasks
            )
        )

    def _success(self) -> bool:
        if not self.selected_tasks:
            return False
        return set(self.selected_tasks) == set(self.get_successful_tasks())

    def _reward(self):
        reward = int(self._success())
        return reward, {
            "reward": reward,
            "successful_tasks": self.get_successful_tasks(),
        }


class CalvinPlayTableEnv(CalvinGoalConditionedEnv):
    """Single-task (slider/drawer) env with optional dense-reward shaping
    (reference: envs/play_table_env.py:11-102). The dense reward is the
    negative distance between the task dim and its target."""

    def __init__(self, task: str = "open_drawer", dense_reward: bool = False,
                 target_value: float = 0.5, scene_dim: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.task = task
        self.dense_reward = dense_reward
        self.target_value = target_value
        self.scene_dim = scene_dim
        self.selected_tasks = [task]

    def _reward(self):
        if not self.dense_reward:
            return super()._reward()
        scene = self.sim.scene.get_obs()
        dist = abs(float(scene[self.scene_dim]) - self.target_value)
        return -dist, {"reward": -dist, "successful_tasks": self.get_successful_tasks()}
