"""Nearest-neighbor goal index (a copy of tacorl_tpu/data/knn.py).

Replaces the reference's faiss-gpu IndexFlatL2 build
(play_dataset.py:204-234, goal_cond_replay_buffer_dataset.py:76-130) with a
blocked exact L2 search in numpy; the index is built once and cached to the
reference's JSON format, so build speed is not on the training path.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["knn_l2", "build_nn_steps_from_step", "load_or_build_nn_index"]


def knn_l2(
    queries: np.ndarray,
    database: np.ndarray,
    k: int,
    block_size: int = 2048,
) -> np.ndarray:
    """Exact k-nearest-neighbor indices under L2, blocked over queries.
    ||q - d||^2 = ||q||^2 - 2 q.d + ||d||^2 ; argpartition per block."""
    database = np.asarray(database, dtype=np.float32)
    queries = np.asarray(queries, dtype=np.float32)
    d_sq = np.sum(database**2, axis=1)
    out = np.empty((len(queries), k), dtype=np.int64)
    for lo in range(0, len(queries), block_size):
        q = queries[lo : lo + block_size]
        dist = np.sum(q**2, axis=1)[:, None] - 2.0 * q @ database.T + d_sq[None]
        idx = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]
        row_dist = np.take_along_axis(dist, idx, axis=1)
        order = np.argsort(row_dist, axis=1)
        out[lo : lo + len(q)] = np.take_along_axis(idx, order, axis=1)
    return out


def build_nn_steps_from_step(
    steps: Sequence[int],
    vectors: np.ndarray,
    num_nn: int = 32,
    margin: int = 16,
) -> Dict[int, List[int]]:
    """For each step, its num_nn nearest steps (by robot_obs L2) excluding
    temporal neighbors within ``margin`` (play_dataset.py:220-229)."""
    steps = list(steps)
    nn_idx = knn_l2(vectors, vectors, num_nn)
    result: Dict[int, List[int]] = {}
    for qi, row in enumerate(nn_idx):
        q_step = steps[qi]
        keep = []
        for ni in row:
            n_step = steps[int(ni)]
            if not (n_step - margin < q_step < n_step + margin):
                keep.append(n_step)
        result[q_step] = keep
    return result


def load_or_build_nn_index(
    cache_path: Union[str, Path],
    data_type: str,
    steps: Sequence[int],
    vectors_fn,
    num_nn: int = 32,
    margin: int = 16,
) -> Dict[int, List[int]]:
    """Cached JSON index keyed by 'train'/'validation' — same file format as
    the reference's nn_steps_from_step.json so existing caches are reusable."""
    cache_path = Path(cache_path).expanduser()
    cache: dict = {}
    if cache_path.is_file():
        with open(cache_path) as f:
            cache = json.load(f)
    if data_type in cache:
        return {int(k): v for k, v in cache[data_type].items()}
    logger.info("building nn_steps_from_step for %s", data_type)
    vectors = vectors_fn()
    index = build_nn_steps_from_step(steps, vectors, num_nn, margin)
    cache[data_type] = {str(k): v for k, v in index.items()}
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(cache, f)
    return index
