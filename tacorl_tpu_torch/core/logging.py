"""Metrics sink (port of tacorl_tpu/core/logging.py): JSONL file + console,
optional wandb when it is installed.

Metric dicts are logged with ``<split>/<name>`` keys. Only rank 0 of a
process group writes (the file, wandb and the console), as the JAX sink
gates on ``jax.process_index()``; the trainer hands every rank the same
(rank-averaged) metrics. Values reach ``log`` as Python floats: the
trainer copies a step's metrics to the host in one batch before it logs.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from tacorl_tpu_torch.parallel.mesh import rank

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["MetricsSink"]


def _to_float(value: Any) -> float:
    return float(np.asarray(value))


class MetricsSink:
    def __init__(
        self,
        directory: Union[str, Path, None] = None,
        use_wandb: bool = False,
        wandb_kwargs: Optional[dict] = None,
        console_every: int = 50,
    ):
        self.is_main = rank() == 0
        self.console_every = console_every
        self._file = None
        if directory is not None and self.is_main:
            path = Path(directory).expanduser()
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb and self.is_main:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logger.warning("wandb requested but not installed; using JSONL")
        self._t0 = time.time()

    def log(
        self, metrics: Dict[str, Any], step: int, prefix: Optional[str] = None
    ) -> None:
        flat = {
            (f"{prefix}/{k}" if prefix else k): _to_float(v)
            for k, v in metrics.items()
        }
        record = {"step": int(step), "time": time.time() - self._t0, **flat}
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(flat, step=int(step))
        if self.is_main and self.console_every and step % self.console_every == 0:
            brief = ", ".join(f"{k}={v:.4g}" for k, v in list(flat.items())[:6])
            logger.info("step %d | %s", step, brief)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        """An (H, W, 3) uint8 image to wandb, where it is in use (as the
        JAX sink does; the JSONL file holds scalars only)."""
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(image)}, step=int(step))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
