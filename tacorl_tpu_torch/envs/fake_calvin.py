"""Fake CALVIN environment (a copy of tacorl_tpu/envs/fake_calvin.py, numpy
only): a deterministic state-machine stand-in for the PyBullet play table.

This is the fake-backend capability the reference lacks (SURVEY.md §4): it
reproduces the goal-conditioned env's API and success semantics
(envs/goal_conditioned_env.py:43-206) — reset from start/goal state info,
goal-image observation, success = selected tasks ⊆ achieved (by diffing
scene_obs between start and current) — with trivially computable dynamics so
rollout managers, evaluation protocols, and callbacks are testable without a
simulator.

Dynamics: robot TCP integrates the relative action; each "task" owns one
scene_obs dimension that moves toward its target while the gripper is closed
near that task's handle location. A scripted expert (``expert_action``) can
therefore complete tasks, giving success-rate tests real signal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tacorl_tpu_torch.envs.base import GoalConditionedEnvBase

__all__ = ["FakeCalvinEnv", "FakePlayTableEnv", "FakeTasks", "TASK_SETS"]

ROBOT_OBS_DIM = 15
SCENE_OBS_DIM = 24

# task name -> (scene_obs dim, handle xyz, threshold)
DEFAULT_TASKS: Dict[str, Tuple[int, Tuple[float, float, float], float]] = {
    "open_drawer": (0, (0.3, 0.0, 0.0), 0.5),
    "move_slider_left": (1, (-0.3, 0.2, 0.0), 0.5),
    "turn_on_led": (2, (0.0, -0.3, 0.1), 0.5),
    "lift_block": (3, (0.1, 0.3, -0.1), 0.5),
}

# Handles in distinct corners, far from the random-start region ([-0.5, 0.5]
# TCP starts are >= ~0.4 from every handle): completing a task requires
# DIRECTED travel toward the right corner, so an untrained policy scores ~0
# and rollout success genuinely measures learning (the train-to-success
# pipeline's table; DEFAULT_TASKS keeps handles central for cheap
# scripted-expert unit tests).
HARD_TASKS: Dict[str, Tuple[int, Tuple[float, float, float], float]] = {
    "open_drawer": (0, (0.7, 0.6, 0.0), 0.5),
    "move_slider_left": (1, (-0.7, 0.6, 0.0), 0.5),
    "turn_on_led": (2, (0.7, -0.6, 0.2), 0.5),
    "lift_block": (3, (-0.7, -0.6, -0.2), 0.5),
}

TASK_SETS = {"default": DEFAULT_TASKS, "hard": HARD_TASKS}


class FakeTasks:
    """Task differ: which tasks' scene dims crossed their threshold between
    two infos (the CALVIN Tasks.get_task_info capability)."""

    def __init__(self, tasks: Optional[Dict] = None):
        self.tasks = tasks or DEFAULT_TASKS

    def get_task_info(self, start_info: Dict, end_info: Dict) -> set:
        start = np.asarray(start_info["scene_obs"])
        end = np.asarray(end_info["scene_obs"])
        done = set()
        for name, (dim, _handle, thresh) in self.tasks.items():
            if end[dim] - start[dim] >= thresh:
                done.add(name)
        return done

    def get_task_info_for_set(
        self, start_info: Dict, end_info: Dict, task_filter: Sequence[str]
    ) -> set:
        return self.get_task_info(start_info, end_info) & set(task_filter)


class FakeCalvinEnv(GoalConditionedEnvBase):
    def __init__(
        self,
        modalities: Sequence[str] = ("rgb_static",),
        goal_modalities: Sequence[str] = ("rgb_static",),
        image_hw: int = 64,
        max_episode_steps: int = 180,
        tasks: Optional[Dict] = None,
        task_set: str = "default",
        action_scale: float = 0.1,
        seed: int = 0,
    ):
        self.modalities = tuple(modalities)
        self.goal_modalities = tuple(goal_modalities)
        self.image_hw = image_hw
        self.max_episode_steps = max_episode_steps
        self.tasks = FakeTasks(tasks if tasks is not None else TASK_SETS[task_set])
        self.action_scale = action_scale
        self._rng = np.random.RandomState(seed)
        self.robot_obs = np.zeros(ROBOT_OBS_DIM, dtype=np.float32)
        self.scene_obs = np.zeros(SCENE_OBS_DIM, dtype=np.float32)
        self.selected_tasks: List[str] = []
        self.goal: Optional[Dict[str, np.ndarray]] = None
        self.start_info: Dict[str, Any] = self.get_info()
        self._steps = 0
        # deterministic stored start/goal state pairs per task — the
        # env_tasks eval strategy's initial_and_goal_states table
        # (goal_conditioned_env.py:72-90 index-reset path)
        table_rng = np.random.RandomState(seed + 1)
        self.initial_and_goal_states: Dict[str, List[Dict]] = {}
        for name, (dim, _handle, thresh) in self.tasks.tasks.items():
            pairs = []
            for _ in range(3):
                robot = table_rng.uniform(-0.4, 0.4, ROBOT_OBS_DIM)
                scene = table_rng.uniform(-0.1, 0.1, SCENE_OBS_DIM)
                goal_scene = scene.copy()
                goal_scene[dim] += thresh + 0.2
                pairs.append(
                    {
                        "start_info": {
                            "robot_obs": robot.astype(np.float32),
                            "scene_obs": scene.astype(np.float32),
                        },
                        "goal_info": {
                            "robot_obs": robot.astype(np.float32),
                            "scene_obs": goal_scene.astype(np.float32),
                        },
                    }
                )
            self.initial_and_goal_states[name] = pairs

    def get_possible_tasks(self) -> Dict[str, int]:
        """{task: number of stored start/goal pairs} (the env_tasks eval
        strategy surface, rollout.py:283-287)."""
        return {
            name: len(pairs)
            for name, pairs in self.initial_and_goal_states.items()
        }

    # -- rendering ------------------------------------------------------------

    def _render_rgb(self) -> np.ndarray:
        """Procedural image encoding the full relevant state: column bands
        for scene dims, a bright patch at the TCP (x, y) whose blue channel
        encodes TCP z and whose red channel encodes the gripper — the image
        alone suffices for visuomotor control (no hidden state), matching
        the static-camera observability of the real playtable."""
        hw = self.image_hw
        img = np.zeros((hw, hw, 3), dtype=np.uint8)
        n = 8
        band = hw // n
        for i in range(n):
            v = np.clip((self.scene_obs[i] + 1.0) / 2.0, 0.0, 1.0)
            img[:, i * band : (i + 1) * band, 0] = int(v * 255)
        tcp = self.robot_obs[:2]
        cx = int(np.clip((tcp[0] + 1) / 2, 0, 1) * (hw - 9))
        cy = int(np.clip((tcp[1] + 1) / 2, 0, 1) * (hw - 9))
        img[cy : cy + 8, cx : cx + 8, 1] = 255
        z = float(np.clip((self.robot_obs[2] + 1.0) / 2.0, 0.0, 1.0))
        img[cy : cy + 8, cx : cx + 8, 2] = int(z * 255)
        gripper_closed = self.robot_obs[14] < 0
        img[cy : cy + 8, cx : cx + 8, 0] = 255 if gripper_closed else 0
        return img

    def _modality_value(self, modality: str) -> np.ndarray:
        if modality == "rgb_static" or modality == "rgb_gripper":
            return self._render_rgb()
        if modality == "depth_static":
            return (
                np.abs(self._render_rgb()[..., 0]).astype(np.float32) / 255.0
            )
        if modality == "robot_obs":
            return self.robot_obs.copy()
        if modality == "scene_obs":
            return self.scene_obs.copy()
        raise KeyError(f"unknown modality {modality}")

    def _obs_dict(self, modalities) -> Dict[str, np.ndarray]:
        return {m: self._modality_value(m) for m in modalities}

    # -- info / success ----------------------------------------------------------

    def get_info(self) -> Dict[str, Any]:
        return {
            "robot_obs": self.robot_obs.copy(),
            "scene_obs": self.scene_obs.copy(),
        }

    def get_state_obs(self) -> Dict[str, np.ndarray]:
        return self.get_info()

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

    # -- reset ---------------------------------------------------------------------

    def _set_state(self, robot_obs=None, scene_obs=None) -> None:
        if robot_obs is not None:
            self.robot_obs = np.asarray(robot_obs, dtype=np.float32).copy()
        if scene_obs is not None:
            self.scene_obs = np.asarray(scene_obs, dtype=np.float32).copy()

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
            self._set_state(robot_obs, scene_obs)
            self.start_info = self.get_info()
            return self.get_obs()
        if task_info is not None:
            return self._set_tasks(task_info)
        # random episode
        self.robot_obs = self._rng.uniform(-0.5, 0.5, ROBOT_OBS_DIM).astype(
            np.float32
        )
        self.scene_obs = self._rng.uniform(-0.2, 0.2, SCENE_OBS_DIM).astype(
            np.float32
        )
        self.selected_tasks = []
        self.goal = self._obs_dict(self.goal_modalities)
        self.start_info = self.get_info()
        return self.get_obs()

    def _set_tasks(self, task_info: dict):
        """reset paths of goal_conditioned_env.py:43-108: complete info,
        stored (task, index) pair, or goal only."""
        if "index" in task_info:
            entry = self.initial_and_goal_states[task_info["task"]][
                task_info["index"]
            ]
            obs = self._set_tasks(
                {
                    "start_info": entry["start_info"],
                    "goal_info": entry["goal_info"],
                    "tasks": [task_info["task"]],
                }
            )
            return obs
        tasks = task_info.get("tasks") or []
        goal_info = task_info["goal_info"]
        if "start_info" in task_info and task_info["start_info"] is not None:
            # render the goal from the goal state, then reset to the start
            self._set_state(**goal_info)
            self.goal = self._obs_dict(self.goal_modalities)
            end_info = self.get_info()
            self._set_state(**task_info["start_info"])
            self.start_info = self.get_info()
        else:
            curr = self.get_state_obs()
            self._set_state(**goal_info)
            self.goal = self._obs_dict(self.goal_modalities)
            end_info = self.get_info()
            self._set_state(**curr)
            self.start_info = self.get_info()
        if tasks:
            self.selected_tasks = list(tasks)
        else:
            self.selected_tasks = sorted(
                self.tasks.get_task_info(self.start_info, end_info)
            )
        return self.get_obs()

    # -- step -------------------------------------------------------------------

    def step(self, action: np.ndarray):
        action = np.asarray(action, dtype=np.float32).reshape(-1)
        assert action.shape[0] == 7
        # discretize gripper (rl_base_env.py:160-165)
        gripper = 1.0 if action[-1] > 0 else -1.0
        self.robot_obs[:6] += self.action_scale * np.clip(action[:6], -1, 1)
        self.robot_obs[:6] = np.clip(self.robot_obs[:6], -1.0, 1.0)
        self.robot_obs[14] = gripper
        # task dynamics: closed gripper near a handle advances that dim
        tcp = self.robot_obs[:3]
        if gripper < 0:
            for _name, (dim, handle, _t) in self.tasks.tasks.items():
                if np.linalg.norm(tcp - np.asarray(handle)) < 0.25:
                    self.scene_obs[dim] += 0.2
        self._steps += 1
        reward, info = self._reward()
        # success-based termination (== bool(reward) for the sparse reward,
        # and the right semantics under FakePlayTableEnv's dense shaping)
        done = self._success() or self._steps >= self.max_episode_steps
        info["success"] = self._success()
        return self.get_obs(), reward, done, info

    def _reward(self):
        reward = int(self._success())
        return reward, {
            "reward": reward,
            "successful_tasks": self.get_successful_tasks(),
        }

    def get_obs(self):
        return {
            "observation": self._obs_dict(self.modalities),
            "goal": self.goal,
        }

    # -- scripted expert (for tests) ---------------------------------------------

    def expert_action(self, gain: float = 1.0) -> np.ndarray:
        """Move toward the first unfinished selected task's handle with the
        gripper closed.

        ``gain < 1`` keeps the continuous dims strictly INSIDE the action
        bounds. Demonstration data whose actions saturate at the bounds is
        pathological for the discretized-logistic decoder: the +-1 edge bins
        absorb the distribution's tails, so an unconditional large-scale
        mixture already scores ~log 2 per saturated dim and NLL training
        never has to learn the state/plan conditioning (the real CALVIN
        teleop deltas are interior, so the reference never hits this)."""
        remaining = [
            t for t in self.selected_tasks if t not in self.get_successful_tasks()
        ]
        action = np.zeros(7, dtype=np.float32)
        action[-1] = -1.0  # closed
        if not remaining:
            return action
        _dim, handle, _t = self.tasks.tasks[remaining[0]]
        delta = np.asarray(handle) - self.robot_obs[:3]
        action[:3] = np.clip(delta / self.action_scale, -1, 1) * gain
        return action


class FakePlayTableEnv(FakeCalvinEnv):
    """Single-task dense-reward variant (the fake counterpart of
    CalvinPlayTableEnv / the reference's envs/play_table_env.py:11-102):
    every episode selects the same task, the goal observation renders the
    completed-task state, and the reward is shaped so online SAC has a
    learnable signal — negative task-dim distance to target (the reference's
    shaping) plus an optional negative TCP-to-handle term (this env's handle
    zone is small relative to the random-policy state distribution, so pure
    scene-distance reward gives sparse exploration signal; the TCP term keeps
    the proof cheap while preserving the reward's optimum)."""

    def __init__(
        self,
        task: str = "open_drawer",
        dense_reward: bool = True,
        tcp_shaping_weight: float = 0.2,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.task = task
        self.dense_reward = dense_reward
        self.tcp_shaping_weight = tcp_shaping_weight

    def reset(self, **kwargs):
        # goal-conditioned resets (task_info / explicit state) keep the base
        # env's semantics — the fixed-task override below would silently
        # discard stored start/goal pairs otherwise (ADVICE r4)
        if kwargs.get("task_info") is not None or any(
            kwargs.get(k) is not None for k in ("robot_obs", "scene_obs")
        ):
            return super().reset(**kwargs)
        super().reset(**kwargs)
        # fixed task; goal renders the scene with the task completed
        dim, _handle, thresh = self.tasks.tasks[self.task]
        cur = self.get_info()
        goal_scene = self.scene_obs.copy()
        goal_scene[dim] += thresh + 0.2
        self._set_state(scene_obs=goal_scene)
        self.goal = self._obs_dict(self.goal_modalities)
        self._set_state(**cur)
        self.start_info = self.get_info()
        self.selected_tasks = [self.task]
        return self.get_obs()

    def _reward(self):
        if not self.dense_reward:
            return super()._reward()
        dim, handle, thresh = self.tasks.tasks[self.task]
        progress = float(
            self.scene_obs[dim] - self.start_info["scene_obs"][dim]
        )
        scene_dist = max(thresh - progress, 0.0)
        tcp_dist = float(
            np.linalg.norm(self.robot_obs[:3] - np.asarray(handle))
        )
        reward = -scene_dist - self.tcp_shaping_weight * tcp_dist
        return reward, {
            "reward": reward,
            "successful_tasks": self.get_successful_tasks(),
        }
