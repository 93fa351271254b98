"""Write the flagship expert-play dataset with the port (the counterpart of
scripts/make_flagship_data.py, which needs the JAX package): 400
distinct-chain training episodes and 40 validation episodes of 4 tasks each
(160 / 120 / 80 / 40 validation chains of depth 1-4), seed 5, both splits
packed into ``PackedStorage`` memmaps with their ``*.json`` span tables
copied beside them.

Usage:
    python -m tacorl_tpu_torch.make_flagship_data [dest]

``dest`` defaults to ``flagship_packed`` in the temporary directory
(``$TMPDIR``).
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.data.storage import pack_frames

__all__ = ["main"]


def main(dest: Path, n_train_episodes: int = 400, n_val_episodes: int = 40) -> Path:
    dest = Path(dest)
    raw = Path(tempfile.mkdtemp(prefix="flagship_raw_"))
    try:
        generate_expert_play(
            raw,
            n_train_episodes=n_train_episodes,
            n_val_episodes=n_val_episodes,
            tasks_per_episode=4,
            idle_steps=(3, 7),
            seed=5,
            distinct_tasks=True,
        )
        dest.mkdir(parents=True, exist_ok=True)
        for split in ("training", "validation"):
            pack_frames(raw / split, dest / split)
            for aux in (raw / split).glob("*.json"):
                shutil.copy(aux, dest / split / aux.name)
    finally:
        shutil.rmtree(raw)
    print(f"flagship dataset packed at {dest}")
    return dest


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else Path(tempfile.gettempdir()) / "flagship_packed")
