"""Interactive dataset-driven real-robot evaluation of the port (mirrors
scripts/evaluate_real_world_from_dataset.py; reference:
scripts/evaluate_real_world_from_dataset.py:41-325).

A StartGoalProposer walks curated (start, goal) frame pairs from a recorded
dataset; an OpenCV window previews the goal image and keyboard input drives
the session: [enter/space] run rollout, [n] next proposal, [q] quit. Results
accumulate into a JSON summary. ``rollout_proposal`` is one rollout of a
proposal, without a window.

Usage:
    python -m tacorl_tpu_torch.evaluate_real_world_from_dataset \
        module_path=runs/tacorl data_dir=/path/to/recording img_path=unused

The module runs on the card; ``+device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from tacorl_tpu_torch.config import compose
from tacorl_tpu_torch.data.storage import open_storage
from tacorl_tpu_torch.evaluate_real_world import CONFIG_DIR, load_agent

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["StartGoalProposer", "rollout_proposal", "main"]


class StartGoalProposer:
    """Curated start/goal frame proposals from a recorded dataset. The task
    table maps task name -> list of (start_step, goal_step) pairs; without a
    table, consecutive spaced frames are proposed."""

    def __init__(
        self,
        data_dir: str,
        task_table: Optional[Dict[str, List[Tuple[int, int]]]] = None,
        modalities=("rgb_static",),
        spacing: int = 64,
    ):
        self.storage = open_storage(Path(data_dir).expanduser())
        self.modalities = list(modalities)
        if task_table:
            self.proposals = [
                (task, s, g) for task, pairs in task_table.items()
                for (s, g) in pairs
            ]
        else:
            steps = getattr(self.storage, "steps", None)
            if steps is None:
                raise ValueError("task_table required for frame-dir storage")
            self.proposals = [
                ("unnamed", int(steps[i]), int(steps[min(i + spacing, len(steps) - 1)]))
                for i in range(0, len(steps) - spacing, spacing)
            ]
        self._idx = -1

    def __len__(self) -> int:
        return len(self.proposals)

    def next(self):
        self._idx = (self._idx + 1) % len(self.proposals)
        task, start_step, goal_step = self.proposals[self._idx]
        start = self.storage.read_frame(start_step, ["robot_obs"])
        goal = self.storage.read_frame(goal_step, self.modalities)
        return task, start["robot_obs"], goal


def rollout_proposal(manager, agent, env, task: str, robot_obs, goal) -> Dict:
    """One rollout from a proposal: the robot reset to the start frame's
    pose, the goal frame as the goal."""
    out = manager.episode_rollout(agent, env, {"goal": goal, "robot_obs": robot_obs})
    logger.info("%s -> %s", task, out)
    return out


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "evaluate_real_world", overrides)
    agent, manager, env = load_agent(cfg)
    proposer = StartGoalProposer(
        cfg["data_dir"],
        task_table=cfg.get("task_table"),
        modalities=cfg.get("modalities", ["rgb_static"]),
    )

    import cv2

    results: Dict[str, list] = {}
    while True:
        task, robot_obs, goal = proposer.next()
        cv2.imshow("goal", np.asarray(goal["rgb_static"])[:, :, ::-1])
        key = cv2.waitKey(0) & 0xFF
        if key == ord("q"):
            break
        if key == ord("n"):
            continue
        results.setdefault(task, []).append(rollout_proposal(manager, agent, env, task, robot_obs, goal))
        with open(cfg.get("filename", "real_world_results.json"), "w") as f:
            json.dump(results, f, indent=4, default=str)
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
