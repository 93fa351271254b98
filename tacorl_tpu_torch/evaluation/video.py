"""Rollout video recording (a copy of tacorl_tpu/evaluation/video.py): frames -> gif/mp4 with a goal thumbnail overlay
(reference: utils/wandb_loggers/video_logger.py:17-117,
utils/misc.py:175-184)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["VideoRecorder", "add_goal_thumbnail"]


def add_goal_thumbnail(frames: np.ndarray, goal_img: np.ndarray) -> np.ndarray:
    """Overlay a 1/3-size goal image in the bottom-left of (T, H, W, 3)
    frames."""
    import cv2

    h, w = frames.shape[1:3]
    th, tw = h // 3, w // 3
    thumb = cv2.resize(goal_img, dsize=(tw, th), interpolation=cv2.INTER_CUBIC)
    out = frames.copy()
    out[:, -th:, :tw] = thumb
    return out


class VideoRecorder:
    def __init__(self, fps: int = 15):
        self.fps = fps
        self.frames: List[np.ndarray] = []
        self.task: Optional[str] = None
        self.goal_img: Optional[np.ndarray] = None

    def new_video(self, initial_img: np.ndarray, task: Optional[str] = None):
        self.frames = [np.asarray(initial_img)]
        self.task = task
        self.goal_img = None

    def update(self, img: np.ndarray) -> None:
        self.frames.append(np.asarray(img))

    def add_goal_thumbnail(self, goal_img: np.ndarray) -> None:
        self.goal_img = np.asarray(goal_img)

    def stacked(self) -> np.ndarray:
        frames = np.stack(self.frames)
        if self.goal_img is not None:
            frames = add_goal_thumbnail(frames, self.goal_img)
        return frames

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        frames = self.stacked()
        if path.suffix == ".gif":
            import imageio

            imageio.mimsave(path, list(frames), fps=self.fps)
        else:
            import cv2

            writer = cv2.VideoWriter(
                str(path),
                cv2.VideoWriter_fourcc(*"MP4V"),
                self.fps,
                (frames.shape[2], frames.shape[1]),
            )
            for frame in frames[..., ::-1]:
                writer.write(frame)
            writer.release()
        return path
