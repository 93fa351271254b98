"""Transition replay buffer with per-transition .npz persistence (a copy of
tacorl_tpu/data/replay_buffer.py; reference: modules/sac/replay_buffer.py:
12-117).

The on-disk format is the JAX package's and the reference's:
``transition_%09d.npz`` with ``state`` / ``action`` / ``next_state`` /
``reward`` / ``done`` entries, the observation dicts pickled and read back
with ``allow_pickle=True`` and ``.item()``; a directory saved by either
package loads in the other. ``sample`` makes the JAX package's numpy calls
in its order (``rng.choice(len, n, replace=False)``, then ``collate``), so
the same transitions and seed give bit-equal batches.
"""

from __future__ import annotations

import logging
from collections import deque, namedtuple
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from tacorl_tpu_torch.data.loader import collate

logger = logging.getLogger("tacorl_tpu_torch")

Transition = namedtuple("Transition", ["state", "action", "next_state", "reward", "done"])

__all__ = ["ReplayBuffer", "Transition"]


class ReplayBuffer:
    def __init__(self, max_capacity: int = 5_000_000):
        self.buffer: deque = deque(maxlen=int(max_capacity))
        self.unsaved_transitions = 0
        self.curr_file_idx = 1

    def __len__(self) -> int:
        return len(self.buffer)

    def clear(self) -> None:
        self.buffer.clear()

    def add_transition(self, state, action, next_state, reward, done) -> None:
        self.buffer.append(Transition(state, action, next_state, reward, done))
        self.unsaved_transitions += 1

    def sample(
        self, batch_size: int, rng: Optional[np.random.Generator] = None, rows: slice = slice(None)
    ) -> Dict:
        """A batch in the transition-dataset format (observations / actions
        / next_observations / rewards / terminals); ``rows`` keeps those
        rows of it (a rank's share of the global batch's draw)."""
        rng = rng or np.random.default_rng()
        n = min(len(self.buffer), batch_size)
        idx = rng.choice(len(self.buffer), n, replace=False)[rows]
        items = [self.buffer[i] for i in idx]
        return {
            "observations": collate([t.state for t in items]),
            "actions": np.stack([np.asarray(t.action) for t in items]).astype(np.float32),
            "next_observations": collate([t.next_state for t in items]),
            "rewards": np.asarray([t.reward for t in items], dtype=np.float32),
            "terminals": np.asarray([t.done for t in items], dtype=np.float32),
        }

    # -- persistence ---------------------------------------------------------------

    def save(self, path) -> bool:
        """Write the transitions added since the last save, numbered on from
        ``curr_file_idx``; False (nothing written) without a path or new
        transitions."""
        if path is None or self.unsaved_transitions == 0:
            return False
        p = Path(path).expanduser()
        p.mkdir(parents=True, exist_ok=True)
        start = len(self.buffer) - self.unsaved_transitions
        for i in range(start, len(self.buffer)):
            t = self.buffer[i]
            np.savez(
                p / f"transition_{self.curr_file_idx:09d}.npz",
                state=t.state,
                action=t.action,
                next_state=t.next_state,
                reward=t.reward,
                done=t.done,
            )
            self.curr_file_idx += 1
        logger.info("saved %d transitions to %s", self.unsaved_transitions, p)
        self.unsaved_transitions = 0
        return True

    def load(self, path) -> bool:
        """Append the first ``maxlen`` transitions saved under ``path``;
        later saves number on after every file there. False without files."""
        if path is None:
            return False
        p = Path(path).expanduser()
        if not p.is_dir():
            return False
        files = sorted(f for f in p.glob("*.npz") if f.is_file())
        self.curr_file_idx = len(files) + 1
        files = files[: self.buffer.maxlen]
        if not files:
            return False
        for file in files:
            data = np.load(file, allow_pickle=True)
            self.buffer.append(
                Transition(
                    data["state"].item(),
                    data["action"],
                    data["next_state"].item(),
                    float(data["reward"]),
                    bool(data["done"]),
                )
            )
        logger.info("loaded %d transitions from %s", len(files), p)
        return True
