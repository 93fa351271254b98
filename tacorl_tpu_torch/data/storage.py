"""Episode storage backends (a copy of tacorl_tpu/data/storage.py; the
batched reads of packed storage go through the native loader,
``data/native.py``, into destinations the caller's ``alloc`` makes).

Two on-disk formats:

* ``FrameDirStorage`` — the reference's CALVIN layout: one ``.npz`` per frame
  named ``<prefix><idx:0Nd>.npz`` plus ``ep_start_end_ids.npy`` /
  ``split.json`` (reference: datamodule/dataset/play_dataset.py:332-355,
  421-446). Kept for drop-in compatibility with existing datasets.

* ``PackedStorage`` — the TPU-first redesign: every modality packed into one
  contiguous ``.npy`` memmap ordered by absolute step, so a training window is
  a zero-copy slice instead of 8-16 npz decompressions. ``pack_frames``
  converts a frame dir once; the input pipeline then sustains TPU-rate
  batches from a single host CPU.

Both expose: ``read_window(start, end, keys)``, ``read_frame(idx, keys)``,
``keys``, and ``ep_start_end_ids``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "FrameDirStorage",
    "PackedStorage",
    "pack_frames",
    "open_storage",
    "load_ep_start_end_ids",
    "load_statistics",
]


def load_ep_start_end_ids(data_dir: Path, train: bool) -> np.ndarray:
    """split.json ({'train*': [[s,e],...], 'val*': ...}) takes priority over
    ep_start_end_ids.npy (play_dataset.py:421-446)."""
    data_dir = Path(data_dir)
    split_file = data_dir / "split.json"
    if split_file.is_file():
        with open(split_file) as f:
            split = json.load(f)
        match = [k for k in split if ("train" if train else "val") in k]
        if not match:
            raise ValueError(f"split.json has no {'train' if train else 'val'} key")
        return np.asarray(split[match[0]])
    npy = data_dir / "ep_start_end_ids.npy"
    if npy.is_file():
        return np.load(npy)
    raise FileNotFoundError(f"no split.json or ep_start_end_ids.npy in {data_dir}")


def load_statistics(data_dir: Path) -> Optional[dict]:
    """statistics.yaml (action bounds + normalization values,
    utils/episode_utils.py:57-94)."""
    path = Path(data_dir) / "statistics.yaml"
    if not path.is_file():
        return None
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


class FrameDirStorage:
    """Per-frame ``.npz`` files with a numeric naming pattern."""

    def __init__(self, data_dir: Union[str, Path], n_digits: Optional[int] = None):
        self.data_dir = Path(data_dir)
        self.prefix, self.suffix, self.n_digits = self._naming_pattern(n_digits)
        sample = np.load(self.frame_path(self._first_idx))
        self.keys: List[str] = list(sample.keys())

    def _naming_pattern(self, n_digits):
        files = sorted(self.data_dir.glob("*.npz"))
        if not files:
            raise FileNotFoundError(f"no .npz files in {self.data_dir}")
        stem = files[0].stem
        digits = re.findall(r"\d+", stem)
        prefix = re.split(r"\d+", stem)[0]
        self._first_idx = int(digits[0])
        return prefix, files[0].suffix, n_digits or len(digits[0])

    def frame_path(self, idx: int) -> Path:
        return self.data_dir / f"{self.prefix}{idx:0{self.n_digits}d}{self.suffix}"

    def read_frame(self, idx: int, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        with np.load(self.frame_path(idx), allow_pickle=True) as data:
            return {k: np.asarray(data[k]) for k in keys}

    def read_window(
        self, start: int, end: int, keys: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        """Frames [start, end) stacked per key (play_dataset.py:357-386)."""
        frames = [self.read_frame(i, keys) for i in range(start, end)]
        return {k: np.stack([f[k] for f in frames]) for k in keys}

    @property
    def ep_start_end_ids_path(self) -> Path:
        return self.data_dir / "ep_start_end_ids.npy"


class PackedStorage:
    """Contiguous memmap-per-key storage. Directory layout:
    ``packed_meta.json`` (keys, shapes, dtypes), ``steps.npy`` (sorted
    absolute step ids), ``<key>.npy`` (one row per step)."""

    META = "packed_meta.json"

    def __init__(self, data_dir: Union[str, Path]):
        self.data_dir = Path(data_dir)
        with open(self.data_dir / self.META) as f:
            self.meta = json.load(f)
        self.steps = np.load(self.data_dir / "steps.npy")
        self.keys: List[str] = list(self.meta["keys"])
        self._arrays = {
            k: np.lib.format.open_memmap(self.data_dir / f"{k}.npy", mode="r")
            for k in self.keys
        }

    def _row(self, step: int) -> int:
        row = int(np.searchsorted(self.steps, step))
        if row >= len(self.steps) or self.steps[row] != step:
            raise KeyError(f"step {step} not in packed storage")
        return row

    def read_frame(self, idx: int, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        row = self._row(idx)
        return {k: np.asarray(self._arrays[k][row]) for k in keys}

    def read_window(
        self, start: int, end: int, keys: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        row = self._row(start)
        n = end - start
        # windows never cross episode boundaries, and steps are contiguous
        # within an episode, so a flat slice is correct
        return {k: np.asarray(self._arrays[k][row : row + n]) for k in keys}

    # -- native batched paths --------------------------------------------------

    def _rows_of(self, steps: Sequence[int]) -> np.ndarray:
        rows = np.searchsorted(self.steps, np.asarray(steps, dtype=np.int64))
        if np.any(rows >= len(self.steps)) or np.any(self.steps[rows] != steps):
            raise KeyError("step(s) not in packed storage")
        return rows

    def read_window_batch(
        self,
        starts: Sequence[int],
        window: int,
        keys: Sequence[str],
        pad_rows: int = 0,
        alloc: Callable[[Tuple[int, ...], np.dtype], Any] = np.empty,
        lengths: Optional[Sequence[int]] = None,
    ) -> Dict[str, Any]:
        """B windows in one multithreaded gather (``csrc/episode_loader.cpp``
        through ``data/native.py``) into ``alloc(shape, dtype)`` per key;
        padding repeats each window's final row. With ``lengths`` only each
        window's first ``lengths[i]`` rows are read, and the rest are left
        for ``native.pad_windows``."""
        from tacorl_tpu_torch.data.native import gather_windows

        rows = self._rows_of(starts)
        out = {}
        for k in keys:
            array = self._arrays[k]
            dest = alloc((len(rows), window + pad_rows) + array.shape[1:], array.dtype)
            out[k] = gather_windows(array, rows, window, pad_rows, dest, lengths)
        return out

    def read_frame_batch(
        self,
        steps: Sequence[int],
        keys: Sequence[str],
        alloc: Callable[[Tuple[int, ...], np.dtype], Any] = np.empty,
    ) -> Dict[str, Any]:
        from tacorl_tpu_torch.data.native import gather_rows

        rows = self._rows_of(steps)
        out = {}
        for k in keys:
            array = self._arrays[k]
            out[k] = gather_rows(array, rows, alloc((len(rows),) + array.shape[1:], array.dtype))
        return out


def pack_frames(
    src_dir: Union[str, Path],
    dst_dir: Union[str, Path],
    keys: Optional[Sequence[str]] = None,
) -> "PackedStorage":
    """One-time conversion FrameDirStorage -> PackedStorage. Copies the split
    metadata (ep_start_end_ids.npy / split.json / statistics.yaml) alongside."""
    src_dir, dst_dir = Path(src_dir), Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    storage = FrameDirStorage(src_dir)
    keys = list(keys) if keys else storage.keys

    steps = sorted(
        int(re.findall(r"\d+", p.stem)[0]) for p in src_dir.glob("*.npz")
    )
    steps_arr = np.asarray(steps, dtype=np.int64)
    np.save(dst_dir / "steps.npy", steps_arr)

    first = storage.read_frame(steps[0], keys)
    arrays = {}
    for k in keys:
        shape = (len(steps),) + first[k].shape
        arrays[k] = np.lib.format.open_memmap(
            dst_dir / f"{k}.npy", mode="w+", dtype=first[k].dtype, shape=shape
        )
    for row, step in enumerate(steps):
        frame = storage.read_frame(step, keys)
        for k in keys:
            arrays[k][row] = frame[k]
    for arr in arrays.values():
        arr.flush()

    meta = {
        "keys": keys,
        "n_steps": len(steps),
        "shapes": {k: list(first[k].shape) for k in keys},
        "dtypes": {k: str(first[k].dtype) for k in keys},
    }
    with open(dst_dir / PackedStorage.META, "w") as f:
        json.dump(meta, f, indent=2)

    for aux in ("ep_start_end_ids.npy", "split.json", "statistics.yaml"):
        src = src_dir / aux
        if src.is_file():
            (dst_dir / aux).write_bytes(src.read_bytes())
    return PackedStorage(dst_dir)


def open_storage(data_dir: Union[str, Path]):
    """Auto-detect packed vs frame-dir storage."""
    data_dir = Path(data_dir)
    if (data_dir / PackedStorage.META).is_file():
        return PackedStorage(data_dir)
    return FrameDirStorage(data_dir)
