"""The benchmark's synthetic CALVIN play set, in the packed layout the
port reads (``packed_meta.json``, ``steps.npy`` and one ``<key>.npy`` row
per step, ``ep_start_end_ids.npy``, ``statistics.yaml``), with CALVIN's
keys and shapes: ``rgb_static`` 200x200x3 uint8, ``rel_actions_world``
(7, the last the gripper at +-1), ``robot_obs`` (15), ``scene_obs`` (24).

Frames follow the pattern of ``tacorl_tpu_torch/data/synthetic.py``
(content that moves with the step), frozen here and given spatial
structure: each frame is a 200x200 crop of a fixed textured canvas whose
position and colour drift along the episode, so a resize, a shift or a
wrong window changes what the encoder sees.

The set does not depend on the run's seed: the seed draws the weights,
the window order and lengths, the goals and the augmentation. It is
written once into the checkout (``build/perfbench/data/<name>``, a fixed
path named by its sizes) and read from there by every later run, as a
user's data set sits on disk between runs.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench" / "data"
VERSION = 1
CANVAS_SEED = 20220916
VECTORS = {"rel_actions_world": 7, "robot_obs": 15, "scene_obs": 24}


def _keys(hw: int) -> Dict:
    return {"rgb_static": ((hw, hw, 3), np.uint8), **{k: ((d,), np.float32) for k, d in VECTORS.items()}}


def store_path(spec: Dict, cache: Path = CACHE) -> Path:
    key = json.dumps({"version": VERSION, **spec}, sort_keys=True)
    return Path(cache) / f"calvin_{hashlib.sha256(key.encode()).hexdigest()[:12]}"


def ensure_store(spec: Dict, cache: Path = CACHE) -> Path:
    """The packed set of ``spec`` (``image_hw``, ``episodes``,
    ``episode_len``, ``val_episodes``, ``val_episode_len``), written if it is not there;
    returns its root (``training/``, ``validation/``)."""
    root = store_path(spec, cache)
    if (root / "done").is_file():
        return root
    tmp = root.with_name(root.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    first = 0
    for split, n_eps, ep_len in (("training", spec["episodes"], spec["episode_len"]),
                                 ("validation", spec["val_episodes"], spec["val_episode_len"])):
        _write_split(tmp / split, first, n_eps, ep_len, int(spec["image_hw"]))
        first += n_eps * ep_len
    (tmp / "done").write_text("ok\n")
    shutil.rmtree(root, ignore_errors=True)
    tmp.rename(root)
    return root


def warm(root: Path) -> int:
    """Read every file of the set once, so that the window reads it from
    the page cache as a run that is past its first epoch does; returns the
    bytes read."""
    buf = bytearray(64 << 20)
    total = 0
    for path in sorted(Path(root).rglob("*.npy")):
        with open(path, "rb", buffering=0) as f:
            while True:
                n = f.readinto(buf)
                if not n:
                    break
                total += n
    return total


def _canvas(rng: np.random.Generator, size: int) -> np.ndarray:
    """A size x size x 3 uint8 texture: 16-pixel blocks of colour plus
    fine noise."""
    blocks = rng.integers(0, 256, (-(-size // 16), -(-size // 16), 3), dtype=np.uint8)
    coarse = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:size, :size].astype(np.int16)
    fine = rng.integers(-24, 25, (size, size, 3), dtype=np.int16)
    return np.clip(coarse + fine, 0, 255).astype(np.uint8)


def _write_split(out: Path, first_step: int, n_eps: int, ep_len: int, hw: int) -> None:
    out.mkdir(parents=True)
    n = n_eps * ep_len
    steps = np.arange(first_step, first_step + n, dtype=np.int64)
    np.save(out / "steps.npy", steps)
    ep_ids = np.asarray([[first_step + e * ep_len, first_step + (e + 1) * ep_len - 1] for e in range(n_eps)])
    np.save(out / "ep_start_end_ids.npy", ep_ids)
    (out / "statistics.yaml").write_text(
        "act_max_bound: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]\n"
        "act_min_bound: [-1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0]\n"
    )
    arrays = {k: np.lib.format.open_memmap(out / f"{k}.npy", mode="w+", dtype=dt, shape=(n,) + shape)
              for k, (shape, dt) in _keys(hw).items()}
    rng = np.random.default_rng([CANVAS_SEED, first_step])
    canvas = _canvas(rng, 2 * hw)
    half = hw // 2
    t = np.arange(ep_len)
    for e in range(n_eps):
        rows = slice(e * ep_len, (e + 1) * ep_len)
        phase = rng.uniform(0, 2 * np.pi, 4)
        # a slow loop over the canvas and a colour drift along the episode
        ys = (half + (half - 1) * np.sin(t / 97.0 + phase[0])).astype(np.int64)
        xs = (half + (half - 1) * np.sin(t / 61.0 + phase[1])).astype(np.int64)
        tint = (40 * np.sin(t[:, None] / 53.0 + phase[2] + np.arange(3))).astype(np.int16)
        rgb = arrays["rgb_static"]
        for i in range(ep_len):
            crop = canvas[ys[i]:ys[i] + hw, xs[i]:xs[i] + hw].astype(np.int16) + tint[i]
            rgb[rows.start + i] = np.clip(crop, 0, 255).astype(np.uint8)
        s = first_step + rows.start + t
        arrays["robot_obs"][rows] = np.sin(np.arange(15)[None] + s[:, None] * 0.1 + phase[3]).astype(np.float32)
        arrays["scene_obs"][rows] = np.cos(np.arange(24)[None] + s[:, None] * 0.05).astype(np.float32)
        rel = np.tanh(rng.standard_normal((ep_len, 7))).astype(np.float32)
        # the gripper holds its state over runs of steps, as a hand does
        rel[:, -1] = np.where(np.sin(t / 23.0 + phase[3]) > 0, 1.0, -1.0)
        arrays["rel_actions_world"][rows] = rel
    for arr in arrays.values():
        arr.flush()
    keys = _keys(hw)
    meta = {"keys": list(keys), "n_steps": n,
            "shapes": {k: list(s) for k, (s, _) in keys.items()},
            "dtypes": {k: np.dtype(d).name for k, (_, d) in keys.items()}}
    (out / "packed_meta.json").write_text(json.dumps(meta, indent=2))
