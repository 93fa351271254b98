"""Dataset -> video dump (port of tacorl_tpu/utils/visualize_frames.py):
render a span of dataset frames to an mp4 (or a gif, where ``imageio`` is
installed) for inspection."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from tacorl_tpu_torch.data.storage import load_ep_start_end_ids, open_storage
from tacorl_tpu_torch.evaluation.video import VideoRecorder

__all__ = ["dump_episode_video"]


def dump_episode_video(
    data_dir: Union[str, Path],
    out_path: Union[str, Path],
    start: Optional[int] = None,
    end: Optional[int] = None,
    modality: str = "rgb_static",
    fps: int = 15,
    train: bool = True,
) -> Path:
    """Frames ``start``..``end`` (inclusive; the first episode of the split
    where not given) of ``modality`` written to ``out_path``."""
    storage = open_storage(Path(data_dir))
    if start is None or end is None:
        bounds = load_ep_start_end_ids(Path(data_dir), train)
        start = int(bounds[0][0]) if start is None else start
        end = int(bounds[0][1]) if end is None else end
    recorder = VideoRecorder(fps=fps)
    recorder.new_video(np.asarray(storage.read_frame(start, [modality])[modality]))
    for step in range(start + 1, end + 1):
        recorder.update(np.asarray(storage.read_frame(step, [modality])[modality]))
    return recorder.save(out_path)
