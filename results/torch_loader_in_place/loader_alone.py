"""The port's loader alone on a card's host, with no training step.

``destinations``: two threads gather batches of 64 windows of 16 rows of
the stage-1 cell's 200x200x3 frames (120,000 B a row) from its page-cached
2.0 GB ``rgb_static`` memmap with the native gather, into three
destinations: a fresh ``np.empty`` array each batch; a fresh array copied
into a page-locked tensor each thread reuses; the reused page-locked tensor
itself. Prints batches/s over ``--batches`` batches, ``--runs`` times each.

``loader``: ``DataLoader`` (2 threads, prefetch 2, pinned) over the
stage-1 cell's set (``PlayWindowDataset``, windows 8-16, batch 64) of the
checkout at ``--checkout`` (its own ``tacorl_tpu_torch``, built there),
timed over ``--batches`` batches after ``--warm``; with the program's
recorder on, the mean ms of each loader phase a batch.

    python results/torch_loader_in_place/loader_alone.py destinations
    python results/torch_loader_in_place/loader_alone.py loader --checkout <dir>

The set is ``perfbench/data.py``'s, written into this checkout's
``build/`` on first use and read once to warm the page cache. Each line of
output is one JSON object, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SPEC = {"image_hw": 200, "episodes": 16, "episode_len": 1040, "val_episodes": 1, "val_episode_len": 64}
BATCH, WINDOW = 64, 16


def _data() -> Path:
    sys.path.insert(0, str(ROOT))
    from perfbench import data

    root = data.ensure_store(SPEC)
    data.warm(root)
    return root / "training"


def _card() -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return q.stdout.strip().splitlines()[0] if q.returncode == 0 and q.stdout.strip() else "no card"


def _emit(out: Path, line: dict) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(text + "\n")


def destinations(args) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from tacorl_tpu_torch.data import native

    array = np.load(_data() / "rgb_static.npy", mmap_mode="r")
    native.get_native_lib()
    rng = np.random.default_rng(args.seed)
    starts = [rng.integers(0, len(array) - WINDOW, size=BATCH) for _ in range(args.batches)]
    shape = (BATCH, WINDOW) + array.shape[1:]

    def fresh(buf, s):
        return native.gather_windows(array, s, WINDOW)

    def fresh_copy(buf, s):
        return buf.copy_(torch.from_numpy(native.gather_windows(array, s, WINDOW)))

    def reused(buf, s):
        return native.gather_windows(array, s, WINDOW, out=buf)

    card = _card()
    for run in range(args.runs):
        for name, fn in (("fresh np.empty", fresh), ("fresh + copy into reused pinned", fresh_copy),
                         ("reused pinned", reused)):
            bufs = {}

            def job(s):
                import threading

                me = threading.get_ident()
                if me not in bufs:
                    bufs[me] = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                fn(bufs[me], s)

            with ThreadPoolExecutor(2) as pool:
                list(pool.map(job, starts[:2]))  # each thread's buffer made before the clock starts
                t0 = time.perf_counter()
                list(pool.map(job, starts))
                dt = time.perf_counter() - t0
            _emit(args.out, {"mode": "destinations", "destination": name, "run": run, "batches": args.batches,
                             "batches_per_s": args.batches / dt, "GB_per_s": args.batches * np.prod(shape) / dt / 1e9,
                             "card": card})


def loader(args) -> None:
    data = _data()
    checkout = Path(args.checkout).resolve()
    sys.path.insert(0, str(checkout))
    from tacorl_tpu_torch.data import loader as loader_mod
    from tacorl_tpu_torch.data import play_dataset
    from tacorl_tpu_torch.utils import profiling

    assert Path(loader_mod.__file__).resolve().is_relative_to(checkout), loader_mod.__file__
    ds = play_dataset.PlayWindowDataset(data, ["rgb_static", "rel_actions_world"], min_window_size=8,
                                        max_window_size=WINDOW)
    dl = loader_mod.DataLoader(ds, batch_size=BATCH, seed=args.seed, num_threads=2, prefetch=2, pin_memory=True)
    def epochs():
        while True:
            yield from dl

    it = epochs()
    for _ in range(args.warm):
        next(it)
    profiling.record(True)
    t0 = time.perf_counter()
    for _ in range(args.batches):
        next(it)
    dt = time.perf_counter() - t0
    profiling.record(False)
    it.close()
    per = collections.defaultdict(list)
    for name, _, start, end, ids, _ in profiling.RECORDER.spans:
        if name.startswith("loader/") and name not in ("loader/wait", "loader/put"):
            per[name].append((end - start) * 1e-6)
    in_place = [c[1] for c in profiling.RECORDER.counts if c[0] == "loader/in_place"]
    _emit(args.out, {"mode": "loader", "label": args.label, "batches": args.batches,
                     "batches_per_s": args.batches / dt, "windows_per_s": args.batches * BATCH / dt,
                     "phase_ms": {k: float(np.mean(v)) for k, v in sorted(per.items())},
                     "in_place_share": float(np.mean(in_place)) if in_place else None, "card": _card()})


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["destinations", "loader"])
    p.add_argument("--checkout", default=str(ROOT))
    p.add_argument("--label", default="change")
    p.add_argument("--batches", type=int, default=40)
    p.add_argument("--warm", type=int, default=16)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "loader_alone.jsonl")
    args = p.parse_args()
    (destinations if args.mode == "destinations" else loader)(args)


if __name__ == "__main__":
    main()
