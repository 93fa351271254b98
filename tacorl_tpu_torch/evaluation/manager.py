"""Evaluation protocols (a copy of tacorl_tpu/evaluation/manager.py;
reference: scripts/evaluate.py:20-253):

  * evaluate_all_tasks      — <=50 rollouts per single task, per-task accuracy
  * evaluate_lh_tasks       — <=1000 long-horizon chains, per-depth accuracy
  * evaluate_lh_seq_tasks   — <=500 sequential chains with intermediate goals,
                              state carried between sub-goals
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["EvaluationManager"]


class EvaluationManager:
    def __init__(
        self,
        agent,
        env,
        rollout_manager,
        single_task_generator=None,
        lh_generator=None,
        lh_seq_generator=None,
    ):
        self.agent = agent
        self.env = env
        self.rollout_manager = rollout_manager
        self.single_task_gen = single_task_generator
        self.lh_gen = lh_generator
        self.lh_seq_gen = lh_seq_generator

    # -- short horizon ---------------------------------------------------------

    def evaluate_task(self, task: str, num_rollouts: int = 5) -> Dict:
        """(scripts/evaluate.py:134-181)"""
        info = {"episode_returns": [], "episodes_lengths": [], "successes": 0}
        n = min(num_rollouts, self.single_task_gen.get_num_rollouts_from_task(task))
        for task_idx in range(n):
            reset_info = self.single_task_gen.get_reset_info(task, task_idx)
            out = self.rollout_manager.episode_rollout(
                self.agent, self.env, reset_info, task=task
            )
            info["episode_returns"].append(out["episode_return"])
            info["episodes_lengths"].append(out["episode_length"])
            info["successes"] += int(out["success"])
        result = {
            "accuracy": info["successes"] / max(n, 1),
            "avg_episode_return": float(np.mean(info["episode_returns"])),
            "avg_episode_length": float(np.mean(info["episodes_lengths"])),
            "num_rollouts": n,
        }
        logger.info("task %s: %s", task, result)
        return result

    def evaluate_all_tasks(
        self, filename: str = "all_tasks.json", max_rollouts_per_task: int = 50
    ) -> Dict:
        all_info: Dict[str, Any] = {}
        for task, tasks in self.single_task_gen.get_rollout_tasks().items():
            all_info[task] = self.evaluate_task(
                task, num_rollouts=min(len(tasks), max_rollouts_per_task)
            )
            _dump(filename, all_info)
        return all_info

    # -- long horizon -----------------------------------------------------------

    def evaluate_lh_tasks(
        self, filename: str = "lh_tasks.json", max_rollouts: int = 1000
    ) -> Dict:
        """(scripts/evaluate.py:43-112)"""
        tasks_per_rollout = self.lh_gen.tasks_per_rollout
        success_accum = np.zeros(tasks_per_rollout)
        accum_len: List[int] = []
        all_info: Dict[str, list] = {}
        rollout_tasks = self.lh_gen.get_rollout_tasks()[:max_rollouts]
        for i, rt in enumerate(rollout_tasks):
            reset_info = {
                "task_info": {
                    "start_info": self.lh_gen.get_state_info_from_step(
                        rt["start_step"]
                    ),
                    "goal_info": self.lh_gen.get_state_info_from_step(
                        rt["end_step"]
                    ),
                    "tasks": rt["completed_tasks"],
                }
            }
            out = self.rollout_manager.episode_rollout(
                self.agent, self.env, reset_info
            )
            name = "__".join(sorted(rt["completed_tasks"]))
            done_tasks = list(out.get("successful_tasks", []))
            all_info.setdefault(name, []).append(
                {**out, "successful_tasks": done_tasks}
            )
            accum_len.append(len(done_tasks))
            success_accum[: len(done_tasks)] += 1
        results = _depth_results(
            success_accum, len(rollout_tasks), accum_len, tasks_per_rollout
        )
        results["tasks_info"] = all_info
        _dump(filename, results)
        return results

    def evaluate_lh_seq_tasks(
        self, filename: str = "lh_seq_tasks.json", max_rollouts: int = 500
    ) -> Dict:
        """Intermediate-goal chains, env state carried between sub-goals
        (scripts/evaluate.py:183-253)."""
        tasks_per_rollout = self.lh_seq_gen.tasks_per_rollout
        success_accum = np.zeros(tasks_per_rollout)
        all_info = {"failed": {}, "success": {}}
        chains = list(self.lh_seq_gen.get_rollout_tasks().items())[:max_rollouts]
        accum_len: List[int] = []
        for start_idx, end_tasks in chains:
            start_info = self.lh_seq_gen.get_state_info_from_step(int(start_idx))
            reset_info: Dict = {"task_info": {"start_info": start_info}}
            success_tasks: List[str] = []
            evaluated_tasks: List[str] = []
            for end_idx, evaluated_tasks in end_tasks.items():
                reset_info["task_info"]["goal_info"] = (
                    self.lh_seq_gen.get_state_info_from_step(int(end_idx))
                )
                out = self.rollout_manager.episode_rollout(
                    self.agent, self.env, reset_info
                )
                success_tasks.extend(out.get("successful_tasks", []))
                # after the first sub-goal, continue from wherever we are
                reset_info["task_info"].pop("start_info", None)
            success_tasks = sorted(set(success_tasks) & set(evaluated_tasks))
            success_accum[: len(success_tasks)] += 1
            accum_len.append(len(success_tasks))
            for t in evaluated_tasks:
                bucket = "success" if t in success_tasks else "failed"
                all_info[bucket][t] = all_info[bucket].get(t, 0) + 1
        results = _depth_results(
            success_accum, len(chains), accum_len, tasks_per_rollout
        )
        results["tasks_info"] = all_info
        _dump(filename, results)
        return results


def _depth_results(success_accum, n_rollouts, accum_len, tasks_per_rollout):
    accuracy = success_accum / max(n_rollouts, 1)
    results = {
        f"lh_{i + 1}_accuracy": float(accuracy[i]) for i in range(len(accuracy))
    }
    results.update(
        {
            "avg_len": float(np.mean(accum_len)) if accum_len else 0.0,
            "num_rollouts": n_rollouts,
            "tasks_per_rollout": tasks_per_rollout,
        }
    )
    return results


def _dump(filename, obj) -> None:
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "w") as f:
        json.dump(obj, f, indent=4)
