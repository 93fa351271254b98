"""Synthetic CALVIN-format dataset generator (a copy of
tacorl_tpu/data/synthetic.py).

Produces the exact on-disk layout the reference's datasets consume
(training/ + validation/ dirs of per-frame .npz files with
ep_start_end_ids.npy, statistics.yaml, start_end_tasks.json) so every data /
eval component can be exercised hermetically in tests and on the card.

Frames carry deterministic content derived from the absolute step index so
tests can verify window alignment after batching/augmentation.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["generate_synthetic_calvin", "frame_arrays"]

ROBOT_OBS_DIM = 15
SCENE_OBS_DIM = 24
ACTION_DIM = 7


def frame_arrays(
    step: int, image_hw: int = 64, gripper_hw: int = 32, rng=None
) -> Dict[str, np.ndarray]:
    """Deterministic frame content for absolute step ``step``."""
    rs = np.random.RandomState(step % (2**31))
    img = np.zeros((image_hw, image_hw, 3), dtype=np.uint8)
    img[..., 0] = step % 251
    img[..., 1] = (step // 251) % 251
    img[..., 2] = rs.randint(0, 255)
    grip = np.zeros((gripper_hw, gripper_hw, 3), dtype=np.uint8)
    grip[..., 0] = (step * 3) % 251
    robot_obs = np.sin(np.arange(ROBOT_OBS_DIM) + step * 0.1).astype(np.float32)
    scene_obs = np.cos(np.arange(SCENE_OBS_DIM) + step * 0.05).astype(np.float32)
    actions = np.tanh(rs.randn(ACTION_DIM)).astype(np.float32)
    actions[-1] = 1.0 if rs.rand() > 0.5 else -1.0
    rel = np.tanh(rs.randn(ACTION_DIM)).astype(np.float32)
    rel[-1] = actions[-1]
    depth = (rs.rand(image_hw, image_hw) * 2.0).astype(np.float32)
    return {
        "rgb_static": img,
        "rgb_gripper": grip,
        "depth_static": depth,
        "robot_obs": robot_obs,
        "scene_obs": scene_obs,
        "actions": actions,
        "rel_actions": rel,
        "rel_actions_world": rel.copy(),
    }


def generate_synthetic_calvin(
    root: Path,
    n_train_episodes: int = 2,
    n_val_episodes: int = 1,
    episode_len: int = 48,
    image_hw: int = 64,
    gripper_hw: int = 32,
    keys: Optional[Sequence[str]] = None,
    with_tasks: bool = True,
) -> Path:
    """Write a synthetic dataset under ``root`` (created if needed)."""
    import yaml

    root = Path(root)
    step = 0
    for split, n_eps in (("training", n_train_episodes), ("validation", n_val_episodes)):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        ep_ids: List[List[int]] = []
        for _ in range(n_eps):
            start = step
            for _ in range(episode_len):
                frame = frame_arrays(step, image_hw, gripper_hw)
                if keys:
                    frame = {k: frame[k] for k in keys}
                np.savez(
                    split_dir / f"episode_{step:07d}.npz", **frame
                )
                step += 1
            ep_ids.append([start, step - 1])
        np.save(split_dir / "ep_start_end_ids.npy", np.asarray(ep_ids))
        stats = {
            "act_min_bound": [-1.0] * ACTION_DIM,
            "act_max_bound": [1.0] * ACTION_DIM,
        }
        with open(split_dir / "statistics.yaml", "w") as f:
            yaml.safe_dump(stats, f)
        if with_tasks:
            _write_tasks(split_dir, ep_ids)
    return root


def _write_tasks(split_dir: Path, ep_ids: List[List[int]]) -> None:
    """start_end_tasks.json: {start_idx: {end_idx: [task names]}}
    (evaluation/rollout_generator.py:24-64 consumes this format)."""
    tasks = {}
    task_names = ["open_drawer", "move_slider_left", "turn_on_led"]
    for start, end in ep_ids:
        span = end - start
        entry = {}
        for i, name in enumerate(task_names):
            lo = start + (i * span) // 4
            hi = min(end, lo + span // 3)
            if hi > lo:
                entry.setdefault(str(lo), {})[str(hi)] = [name]
        tasks.update(entry)
    with open(split_dir / "start_end_tasks.json", "w") as f:
        json.dump(tasks, f)
