"""Scripted-expert play data on the fake CALVIN env (a copy of
tacorl_tpu/data/expert_play.py).

Generates teleoperated-style "play" episodes (the uncurated data regime of
the reference, README.md:8) by driving ``FakeCalvinEnv``'s scripted expert
through random task sequences with idle wandering in between, and writes
them in the exact CALVIN on-disk layout the data stack consumes
(per-frame .npz + ep_start_end_ids.npy + statistics.yaml +
start_end_tasks.json; datamodule/dataset/play_dataset.py:332-386 upstream).

Unlike ``generate_synthetic_calvin`` (procedural frames for window-alignment
tests), the frames here come from a real closed-loop policy on the env's
dynamics, and every recorded start/end span in ``start_end_tasks.json`` is a
*verified* task completion — so a policy trained on this data can be
evaluated for true rollout success through the same eval path the reference
monitors (scripts/evaluate.py:171-176, utils/callbacks/rollout.py:542-546).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv

__all__ = ["generate_expert_play"]

# statistics.yaml with the action bounds, as yaml.safe_dump writes
# {"act_min_bound": [-1.0] * 7, "act_max_bound": [1.0] * 7}: written as text,
# so the generator needs no YAML writer
_STATISTICS_YAML = "".join(
    f"{key}:\n" + f"- {bound}\n" * 7
    for key, bound in (("act_max_bound", 1.0), ("act_min_bound", -1.0))
)


def _record_frame(env: FakeCalvinEnv, action: np.ndarray) -> Dict[str, np.ndarray]:
    """Frame = state BEFORE the action + the action taken at that state."""
    action = action.astype(np.float32)
    return {
        "rgb_static": env._render_rgb(),
        "robot_obs": env.robot_obs.copy(),
        "scene_obs": env.scene_obs.copy(),
        "actions": action.copy(),
        "rel_actions": action.copy(),
        "rel_actions_world": action.copy(),
    }


def _wander_action(env: FakeCalvinEnv, waypoint: np.ndarray) -> np.ndarray:
    """Move the TCP toward a free-space waypoint with the gripper closed
    (play data keeps the expert's gripper convention); interior actions,
    like the expert (see FakeCalvinEnv.expert_action)."""
    action = np.zeros(7, dtype=np.float32)
    action[-1] = -1.0
    action[:3] = np.clip(
        (waypoint - env.robot_obs[:3]) / env.action_scale, -1, 1
    ) * 0.7
    return action


def generate_expert_play(
    root: Path,
    n_train_episodes: int = 24,
    n_val_episodes: int = 6,
    tasks_per_episode: int = 3,
    image_hw: int = 64,
    max_task_steps: int = 40,
    idle_steps: Tuple[int, int] = (2, 5),
    action_noise: float = 0.05,
    expert_gain: float = 0.7,
    seed: int = 0,
    tasks: Optional[Dict] = None,
    task_set: str = "hard",
    distinct_tasks: bool = False,
) -> Path:
    """Write an expert-play dataset under ``root``; returns ``root``.

    ``action_noise`` perturbs the expert's continuous action dims so the
    data covers a tube around the optimal trajectories (behavior-cloning
    needs state diversity to recover from its own drift).

    ``start_end_tasks.json`` records every completed chain span, not just
    single tasks: for a chain t1 -> t2 -> t3 inside one episode it holds
    {start_1: {end_1: [t1], end_2: [t1, t2], end_3: [t1, t2, t3]},
    start_2: {...}} — exactly the multi-depth table the reference's
    long-horizon generators consume (evaluation/rollout_generator.py:137-242
    upstream). Each entry's task list is the diff-verified completed set over
    the recorded frames, filtered to the tasks the expert attempted in the
    span; a chain stops extending at the first uncompleted attempt.

    ``distinct_tasks=True`` samples each episode's chain without replacement
    (repeated tasks collapse in the diffed completed set, so chains with
    repeats never reach depth == chain length); the default keeps the exact
    sampling — and therefore the exact RNG stream and frames — of earlier
    datasets."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    step = 0
    for split, n_eps in (
        ("training", n_train_episodes),
        ("validation", n_val_episodes),
    ):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        ep_ids: List[List[int]] = []
        spans: Dict[str, Dict[str, List[str]]] = {}
        for ep in range(n_eps):
            env = FakeCalvinEnv(
                modalities=("rgb_static",),
                image_hw=image_hw,
                max_episode_steps=10**9,
                seed=int(rng.randint(2**31)),
                tasks=tasks,
                task_set=task_set,
            )
            env.reset()
            frames: List[Dict[str, np.ndarray]] = []
            ep_start = step
            task_names = list(env.tasks.tasks)
            chosen = rng.choice(
                task_names,
                size=tasks_per_episode,
                replace=not distinct_tasks,
            )
            # (span_start, span_end, task, completed) per attempted task, in
            # chain order — consumed by the multi-depth span pass below
            task_records: List[Tuple[int, int, str, bool]] = []
            for task in chosen:
                span_start = ep_start + len(frames)
                start_info = env.get_info()
                env.selected_tasks = [task]
                env.start_info = start_info
                completed = False
                for _ in range(max_task_steps):
                    action = env.expert_action(gain=expert_gain)
                    # clip to strictly-interior bounds: saturated targets are
                    # degenerate for the discretized-logistic NLL (see
                    # FakeCalvinEnv.expert_action)
                    action[:6] = np.clip(
                        action[:6]
                        + rng.randn(6).astype(np.float32) * action_noise,
                        -0.95,
                        0.95,
                    )
                    frames.append(_record_frame(env, action))
                    env.step(action)
                    if env.tasks.get_task_info_for_set(
                        start_info, env.get_info(), [task]
                    ):
                        completed = True
                        break
                # idle wander; its first frame is the span's goal frame (the
                # first recorded state that shows the completed task)
                span_end = ep_start + len(frames)
                env.selected_tasks = []
                waypoint = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
                for _ in range(int(rng.randint(*idle_steps))):
                    action = _wander_action(env, waypoint)
                    frames.append(_record_frame(env, action))
                    env.step(action)
                task_records.append((span_start, span_end, str(task), completed))
            # multi-depth spans: for every chain i..j of consecutively
            # completed attempts, record the diff-verified completed set
            # between the chain's start frame and attempt j's goal frame
            for i, (chain_start, _e, _t, ok_i) in enumerate(task_records):
                if not ok_i:
                    continue
                start_scene = frames[chain_start - ep_start]["scene_obs"]
                attempted: set = set()
                for span_start_j, span_end_j, task_j, ok_j in task_records[i:]:
                    if not ok_j:
                        break  # a failed attempt breaks every chain through it
                    attempted.add(task_j)
                    goal_scene = frames[span_end_j - ep_start]["scene_obs"]
                    achieved = env.tasks.get_task_info(
                        {"scene_obs": start_scene}, {"scene_obs": goal_scene}
                    ) & attempted
                    if achieved != attempted:
                        break  # chain verification failed at this depth
                    spans.setdefault(str(chain_start), {})[
                        str(span_end_j)
                    ] = sorted(achieved)
            for frame in frames:
                np.savez(split_dir / f"episode_{step:07d}.npz", **frame)
                step += 1
            ep_ids.append([ep_start, step - 1])
        np.save(split_dir / "ep_start_end_ids.npy", np.asarray(ep_ids))
        (split_dir / "statistics.yaml").write_text(_STATISTICS_YAML)
        with open(split_dir / "start_end_tasks.json", "w") as f:
            json.dump(spans, f)
    return root
