"""The loader's batches, worked out again from the data set's raw files:
the shuffled window order of an epoch, each row's window length, the
window's frames read from the packed ``.npy`` files and padded (frames and
state repeat the last real step; relative actions are zero past it, the
gripper column repeating), as ``PlayWindowDataset`` and ``DataLoader``
define them.

Epoch ``e`` (from 0) of a loader seeded ``seed`` orders the window starts
by ``default_rng(seed + e).shuffle``; batch ``b`` draws its rows' window
lengths from ``default_rng((seed, e + 1, b))``, one ``integers(lo, hi +
1)`` per row in the batch's order, and then, with goals, each row's goal
in turn: a strategy by its probability; for ``geometric`` a displacement
d ~ Geometric(p) and the frame (length - 1) * d steps past the window's
start, at most the episode's end; for ``similar_robot_obs`` a uniform pick
among the robot-state nearest neighbours of the window's last frame (the
``num_nn`` nearest by L2 over every step but each episode's last, those
within ``margin`` steps of it left out), or a uniform window start when
it has none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def knn_l2(queries: np.ndarray, database: np.ndarray, k: int, block: int = 2048) -> np.ndarray:
    """Exact k nearest neighbours under L2 in float32, blocked over the
    queries: ||q||^2 - 2 q.d + ||d||^2, the k smallest in order."""
    d_sq = np.sum(database ** 2, axis=1)
    out = np.empty((len(queries), k), dtype=np.int64)
    for lo in range(0, len(queries), block):
        q = queries[lo:lo + block]
        dist = np.sum(q ** 2, axis=1)[:, None] - 2.0 * q @ database.T + d_sq[None]
        idx = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(dist, idx, axis=1), axis=1)
        out[lo:lo + len(q)] = np.take_along_axis(idx, order, axis=1)
    return out


class Windows:
    """The training split of a packed set, read from its files."""

    def __init__(self, split_dir: Path, min_window: int, max_window: int, goals: Optional[dict] = None):
        split_dir = Path(split_dir)
        self.min_window, self.max_window, self.goals = min_window, max_window, goals
        self.steps = np.load(split_dir / "steps.npy")
        self.arrays = {k: np.load(split_dir / f"{k}.npy", mmap_mode="r")
                       for k in ("rgb_static", "rel_actions_world", "robot_obs")}
        self.episodes = np.load(split_dir / "ep_start_end_ids.npy")
        self.starts = np.concatenate([np.arange(s, e + 1 - max_window) for s, e in self.episodes]).astype(np.int64)
        self._neighbours = None

    def _row(self, step: int) -> int:
        return int(np.searchsorted(self.steps, step))

    def neighbours(self) -> Dict[int, List[int]]:
        if self._neighbours is None:
            steps = [s for a, b in self.episodes for s in range(a, b)]
            vectors = np.asarray(self.arrays["robot_obs"][[self._row(s) for s in steps]], dtype=np.float32)
            margin = self.goals["margin"]
            self._neighbours = {
                steps[q]: [steps[n] for n in row if not (steps[n] - margin < steps[q] < steps[n] + margin)]
                for q, row in enumerate(knn_l2(vectors, vectors, self.goals["num_nn"]))
            }
        return self._neighbours

    def _goal(self, start: int, length: int, rng: np.random.Generator):
        """(goal step, displacement or -1) of one row."""
        names = list(self.goals["strategy_prob"])
        strategy = rng.choice(names, p=[self.goals["strategy_prob"][k] for k in names])
        if strategy == "geometric":
            end = next(int(b) for a, b in self.episodes if a <= start <= b)
            disp = int(rng.geometric(p=self.goals["sampling_prob"]))
            return min(end, start + (length - 1) * disp), disp
        options = self.neighbours().get(start + length - 1, [])
        return int(rng.choice(options) if options else rng.choice(self.starts)), -1

    def batch_rows(self, seed: int, batch_size: int, epoch: int, index: int):
        """(window starts, window lengths) of batch ``index`` of ``epoch``."""
        order = np.arange(len(self.starts))
        np.random.default_rng(seed + epoch).shuffle(order)
        idx = order[index * batch_size:(index + 1) * batch_size]
        rng = np.random.default_rng((seed, epoch + 1, index))
        lengths = np.asarray([int(rng.integers(self.min_window, self.max_window + 1)) for _ in idx])
        starts = self.starts[idx]
        goals = [self._goal(int(s), int(n), rng) for s, n in zip(starts, lengths)] if self.goals else []
        return starts, lengths, goals

    def batch(self, seed: int, batch_size: int, epoch: int, index: int, device) -> Dict[str, torch.Tensor]:
        starts, lengths, goals = self.batch_rows(seed, batch_size, epoch, index)
        out: Dict[str, List[np.ndarray]] = {"rgb_static": [], "actions": []}
        if goals:
            out["goal"] = [np.asarray(self.arrays["rgb_static"][self._row(g)]) for g, _ in goals]
            out["disp"] = [np.int64(d) for _, d in goals]
        for start, n in zip(starts, lengths):
            rows = np.searchsorted(self.steps, start) + np.arange(n)
            rgb = np.asarray(self.arrays["rgb_static"][rows])
            act = np.asarray(self.arrays["rel_actions_world"][rows])
            pad = self.max_window - n
            rgb = np.concatenate([rgb, np.repeat(rgb[-1:], pad, 0)])
            tail = np.zeros((pad, act.shape[1]), np.float32)
            tail[:, -1] = act[-1, -1]
            out["rgb_static"].append(rgb)
            out["actions"].append(np.concatenate([act, tail]))
        return {k: torch.as_tensor(np.stack(v)).to(device) for k, v in out.items()}
