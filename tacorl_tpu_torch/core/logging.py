"""Metrics sink (port of tacorl_tpu/core/logging.py): JSONL file + console,
optional wandb when it is installed.

Metric dicts are logged with ``<split>/<name>`` keys. The port runs one
process, so it is rank 0 and always writes (data-parallel training is
ROADMAP Queue 1, item 16). Values reach ``log`` as Python floats: the
trainer copies a step's metrics to the host in one batch before it logs.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

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
        self.console_every = console_every
        self._file = None
        if directory is not None:
            path = Path(directory).expanduser()
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
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
        if self.console_every and step % self.console_every == 0:
            brief = ", ".join(f"{k}={v:.4g}" for k, v in list(flat.items())[:6])
            logger.info("step %d | %s", step, brief)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
