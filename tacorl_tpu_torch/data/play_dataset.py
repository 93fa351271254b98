"""CALVIN sliding-window play dataset (port of
tacorl_tpu/data/play_dataset.py).

Semantics parity with the reference PlayDataset
(datamodule/dataset/play_dataset.py:30-473): episode lookup over
ep_start_end_ids, per-item random window in [min,max] for train / a
deterministic hashed window for validation, window padding (repeat last frame;
zero-pad relative actions except the gripper channel), and the two goal
branches (geometric-displacement future state / similar-robot-obs NN goal).

Differences from the reference, as in the JAX package:
  * samples return RAW frames (uint8 images, numpy); all image transforms
    run on the device inside the train step (data/transforms.py).
  * randomness is an explicit ``np.random.Generator`` per call — no global
    RNG, so the pipeline is reproducible and shardable across hosts.
  * the validation window hash is a stable md5 (the reference uses Python's
    per-process-salted ``hash()``, play_dataset.py:25-27 — a defect we do not
    replicate).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from tacorl_tpu_torch.data.knn import load_or_build_nn_index
from tacorl_tpu_torch.data.native import pad_windows
from tacorl_tpu_torch.data.storage import PackedStorage, load_ep_start_end_ids, open_storage
from tacorl_tpu_torch.utils.profiling import spans

__all__ = ["PlayWindowDataset", "validation_window_size"]

STATE_INFO_KEYS = ("robot_obs", "scene_obs")


def validation_window_size(idx: int, min_ws: int, max_ws: int) -> int:
    window_range = max_ws - min_ws + 1
    digest = hashlib.md5(str(idx).encode()).digest()
    return min_ws + int.from_bytes(digest[:4], "little") % window_range


class PlayWindowDataset:
    def __init__(
        self,
        data_dir: Union[str, Path],
        modalities: Sequence[str],
        action_type: str = "rel_actions_world",
        train: bool = True,
        real_world: bool = False,
        min_window_size: int = 16,
        max_window_size: int = 32,
        pad: bool = True,
        include_goal: bool = False,
        goal_augmentation: bool = False,
        goal_sampling_prob: float = 0.3,
        goal_strategy_prob: Optional[Dict[str, float]] = None,
        nn_steps_from_step_path: str = "nn_steps_from_step.json",
        num_nn: int = 32,
    ):
        modalities = list(modalities)
        if action_type not in modalities:
            raise ValueError(f"{action_type} must be in modalities")
        if real_world and "scene_obs" in modalities:
            modalities.remove("scene_obs")
        self.modalities = modalities
        self.action_type = action_type
        self.train = train
        self.real_world = real_world
        self.min_window_size = min_window_size
        self.max_window_size = max_window_size
        self.pad = pad
        self.data_dir = Path(data_dir)
        self.storage = open_storage(self.data_dir)
        self.ep_start_end_ids = load_ep_start_end_ids(self.data_dir, train)
        self.episode_lookup = self._build_episode_lookup()
        self.include_goal = include_goal
        self.goal_augmentation = goal_augmentation
        self.goal_sampling_prob = goal_sampling_prob
        if include_goal:
            self.goal_strategy_prob = goal_strategy_prob or {
                "geometric": 0.5,
                "similar_robot_obs": 0.5,
            }
            if not np.isclose(sum(self.goal_strategy_prob.values()), 1.0):
                raise ValueError(f"goal_strategy_prob must sum to 1: {self.goal_strategy_prob}")
            if "similar_robot_obs" in self.goal_strategy_prob:
                nn_path = Path(nn_steps_from_step_path).expanduser()
                if not nn_path.is_absolute():
                    nn_path = self.data_dir / nn_path
                self.nn_steps_from_step = load_or_build_nn_index(
                    nn_path,
                    "train" if train else "validation",
                    steps=self._all_steps(),
                    vectors_fn=self._robot_obs_matrix,
                    num_nn=num_nn,
                )

    # -- construction helpers -------------------------------------------

    def _build_episode_lookup(self) -> np.ndarray:
        """Possible window start frames (play_dataset.py:448-473)."""
        lookup: List[int] = []
        for start_idx, end_idx in self.ep_start_end_ids:
            if end_idx <= self.max_window_size:
                raise ValueError(f"episode {start_idx}-{end_idx} shorter than the window")
            lookup.extend(range(start_idx, end_idx + 1 - self.max_window_size))
        return np.asarray(lookup, dtype=np.int64)

    def _all_steps(self) -> List[int]:
        steps: List[int] = []
        for start, end in self.ep_start_end_ids:
            steps.extend(range(start, end))
        return steps

    def _robot_obs_matrix(self) -> np.ndarray:
        steps = self._all_steps()
        return np.stack(
            [self.storage.read_frame(s, ["robot_obs"])["robot_obs"] for s in steps]
        ).astype(np.float32)

    def __len__(self) -> int:
        return len(self.episode_lookup)

    # -- sampling --------------------------------------------------------

    def _window_size(self, idx: int, rng: np.random.Generator) -> int:
        if self.min_window_size == self.max_window_size:
            return self.max_window_size
        if self.min_window_size > self.max_window_size:
            raise ValueError("min_window_size > max_window_size")
        if self.train:
            return int(
                rng.integers(self.min_window_size, self.max_window_size + 1)
            )
        return validation_window_size(
            idx, self.min_window_size, self.max_window_size
        )

    def sample(
        self,
        idx: int,
        rng: Optional[np.random.Generator] = None,
        window_size: Optional[int] = None,
    ) -> Dict:
        rng = rng or np.random.default_rng()
        if window_size is None:
            window_size = self._window_size(idx, rng)
        seq = self._get_window(idx, window_size)
        if self.pad:
            seq = self._pad_sequence(seq, window_size)
        item = {
            "states": {
                m: seq[m] for m in self.modalities if "action" not in m
            },
            "actions": seq[self.action_type],
            "idx": np.int64(idx),
            "window_size": np.int64(window_size),
        }
        if not self.real_world:
            item["state_info"] = seq["state_info"]
        if self.include_goal:
            strategy = rng.choice(
                list(self.goal_strategy_prob.keys()),
                p=list(self.goal_strategy_prob.values()),
            )
            if strategy == "geometric":
                item["goal"], item["disp"] = self._future_state(
                    idx, window_size, rng
                )
            else:
                seq_start = int(self.episode_lookup[idx])
                item["goal"] = self._similar_robot_obs_state(
                    seq_start + window_size - 1, rng
                )
                item["disp"] = np.int64(-1)
        return item

    def _get_window(self, idx: int, window_size: int) -> Dict:
        start = int(self.episode_lookup[idx])
        keys = list(self.modalities)
        if not self.real_world:
            for k in STATE_INFO_KEYS:
                if k not in keys:
                    keys.append(k)
        seq = self.storage.read_window(start, start + window_size, keys)
        if not self.real_world:
            seq["state_info"] = {k: seq[k].copy() for k in STATE_INFO_KEYS}
        return seq

    # -- padding (play_dataset.py:282-330) --------------------------------

    def _pad_sequence(self, seq: Dict, window_size: int) -> Dict:
        pad_size = self.max_window_size - window_size
        if pad_size == 0:
            return seq
        for m in self.modalities:
            if "rel" in m:
                cont = _pad_zeros(seq[m][..., :-1], pad_size)
                grip = _pad_repeat(seq[m][..., -1:], pad_size)
                seq[m] = np.concatenate([cont, grip], axis=-1)
            else:
                seq[m] = _pad_repeat(seq[m], pad_size)
        if not self.real_world:
            seq["state_info"] = {
                k: _pad_repeat(v, pad_size) for k, v in seq["state_info"].items()
            }
        return seq

    # -- goals -------------------------------------------------------------

    def _state_keys(self) -> List[str]:
        return [m for m in self.modalities if "action" not in m]

    def _read_state(self, step: int) -> Dict[str, np.ndarray]:
        return self.storage.read_frame(step, self._state_keys())

    def _random_state(self, rng) -> Dict[str, np.ndarray]:
        return self._read_state(int(rng.choice(self.episode_lookup)))

    def _episode_end(self, step: int) -> Optional[int]:
        for start, end in self.ep_start_end_ids:
            if start <= step <= end:
                return int(end)
        return None

    def _future_state(self, idx: int, window_size: int, rng):
        """Geometric-displacement goal (play_dataset.py:258-276): the goal is
        the state ``(window-1) * disp`` frames ahead, disp ~ Geom(p)."""
        seq_start = int(self.episode_lookup[idx])
        episode_end = self._episode_end(seq_start)
        if episode_end is None:
            return self._random_state(rng), np.int64(-1)
        disp = int(rng.geometric(p=self.goal_sampling_prob))
        goal_step = seq_start + (window_size - 1) * disp
        if self.goal_augmentation:
            goal_step += int(rng.integers(0, 3)) - 1
        file_step = min(episode_end, goal_step)
        return self._read_state(file_step), np.int64(disp)

    def _similar_robot_obs_state(self, step: int, rng):
        options = self.nn_steps_from_step.get(step, [])
        if not options:
            return self._random_state(rng)
        return self._read_state(int(rng.choice(options)))

    # -- batched fast path (packed storage + native gather) -------------------

    def supports_batch(self) -> bool:
        return isinstance(self.storage, PackedStorage)

    def sample_batch(
        self,
        indices: Sequence[int],
        rng: np.random.Generator,
        rows: slice = slice(None),
        alloc: Callable[[Tuple[int, ...], np.dtype], Any] = np.empty,
    ) -> Dict:
        """One multithreaded gather for the whole batch, identical to
        per-item sample()+collate: each window's real rows are read into
        its place in a max_window_size batch, and with ``pad`` the rows past
        them are filled in place by the native pad fill (repeat-last frames;
        zero relative actions except the repeated gripper channel; without
        ``pad`` every window reads max_window_size rows). The windows and
        the goal frames are written into ``alloc(shape, dtype)`` per key
        (the loader's page-locked tensors on a card). ``rows`` keeps those rows of the batch (a rank's share):
        every row's draws are made, in the order of the whole batch, and
        only the kept rows are read, so they equal those rows of the whole
        batch."""
        indices = np.asarray(indices, dtype=np.int64)
        with spans("loader/draws"):
            window_sizes = np.asarray(
                [self._window_size(int(i), rng) for i in indices], dtype=np.int64
            )
            starts = self.episode_lookup[indices]
            if self.include_goal:
                goal_steps, disps = self._goal_steps(starts, window_sizes, rng)
                goal_steps, disps = goal_steps[rows], disps[rows]
        indices, window_sizes, starts = indices[rows], window_sizes[rows], starts[rows]
        keys = list(self.modalities)
        if not self.real_world:
            for k in STATE_INFO_KEYS:
                if k not in keys:
                    keys.append(k)
        # both reads in one span: the goal frames are read before the pad
        # fill, which touches only the windows
        with spans("loader/gather"):
            data = self.storage.read_window_batch(
                starts, self.max_window_size, keys, alloc=alloc,
                lengths=window_sizes if self.pad else None,
            )
            if self.include_goal:
                goals = self.storage.read_frame_batch(
                    goal_steps, self._state_keys(), alloc=alloc
                )
        with spans("loader/pad"):
            if self.pad:
                for m in keys:
                    pad_windows(data[m], window_sizes, relative="rel" in m)
        batch = {
            "states": {
                m: data[m] for m in self.modalities if "action" not in m
            },
            "actions": data[self.action_type],
            "idx": indices,
            "window_size": window_sizes,
        }
        if not self.real_world:
            batch["state_info"] = {k: data[k] for k in STATE_INFO_KEYS}
        if self.include_goal:
            batch["goal"] = goals
            batch["disp"] = disps
        return batch

    def _goal_steps(self, starts, window_sizes, rng):
        """Each row's goal frame and displacement (-1 off the geometric
        strategy), drawn row by row as the per-item path draws them."""
        b = len(starts)
        goal_steps = np.empty(b, dtype=np.int64)
        disps = np.empty(b, dtype=np.int64)
        for i in range(b):
            strategy = rng.choice(
                list(self.goal_strategy_prob.keys()),
                p=list(self.goal_strategy_prob.values()),
            )
            ws = int(window_sizes[i])
            seq_start = int(starts[i])
            if strategy == "geometric":
                episode_end = self._episode_end(seq_start)
                if episode_end is None:
                    # same fallback as _future_state (per-item path):
                    # a start outside every episode gets a random goal
                    goal_steps[i] = int(rng.choice(self.episode_lookup))
                    disps[i] = -1
                    continue
                disp = int(rng.geometric(p=self.goal_sampling_prob))
                goal_step = seq_start + (ws - 1) * disp
                if self.goal_augmentation:
                    goal_step += int(rng.integers(0, 3)) - 1
                goal_steps[i] = min(episode_end, goal_step)
                disps[i] = disp
            else:
                options = self.nn_steps_from_step.get(
                    seq_start + ws - 1, []
                )
                goal_steps[i] = (
                    int(rng.choice(options))
                    if options
                    else int(rng.choice(self.episode_lookup))
                )
                disps[i] = -1
        return goal_steps, disps


def _pad_repeat(arr: np.ndarray, pad: int) -> np.ndarray:
    last = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, last], axis=0)


def _pad_zeros(arr: np.ndarray, pad: int) -> np.ndarray:
    zeros = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, zeros], axis=0)
