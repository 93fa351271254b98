"""Checkpoint store (port of ``CheckpointManager`` and
``load_module_from_checkpoint`` of tacorl_tpu/core/checkpoint.py), in the
port's own format:

    <dir>/config.json               experiment config (round-trip record)
    <dir>/ckpts/<step>/state.pt     torch.save of TrainState.state_dict():
                                    step, the net's state_dict (the
                                    reference layout) and the optimizer's

Every save is kept: top-K-by-metric retention is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from tacorl_tpu_torch.config import get_class, merge

__all__ = ["CheckpointManager", "load_module_from_checkpoint"]


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], config: Optional[dict] = None):
        self.dir = Path(directory).expanduser()
        self.ckpt_dir = self.dir / "ckpts"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        if config is not None:
            (self.dir / "config.json").write_text(json.dumps(config, indent=1))

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / str(step) / "state.pt"

    def save(self, step: int, state: Any) -> None:
        """``state`` is a TrainState (or anything with ``state_dict``)."""
        path = self._path(step)
        path.parent.mkdir(parents=True, exist_ok=True)
        partial = path.with_suffix(".tmp")
        torch.save(state.state_dict(), partial)
        partial.replace(path)

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name) for p in self.ckpt_dir.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / "state.pt").is_file()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self, step: Optional[int] = None, map_location: Union[str, torch.device] = "cpu"
    ) -> Dict[str, Any]:
        """The saved state dict of ``step`` (the latest when None or < 0)."""
        if step is None or step < 0:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def load_config(self) -> dict:
        return json.loads((self.dir / "config.json").read_text())


def load_module_from_checkpoint(
    directory: Union[str, Path],
    step: int = -1,
    overwrite_cfg: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
):
    """Re-instantiate a port module from the config saved beside its
    checkpoints (its ``module`` entry, or the whole config; ``_target_:
    tacorl_tpu.X`` resolves to the port's class) on ``device`` and restore
    its state. ``overwrite_cfg`` overrides keys of the module config.
    Returns (module, state)."""
    manager = CheckpointManager(directory)
    cfg = manager.load_config()
    if overwrite_cfg:
        cfg = merge(cfg, {"module": overwrite_cfg} if "module" in cfg else overwrite_cfg)
    module_cfg = cfg["module"] if "module" in cfg else cfg
    cls = get_class(module_cfg["_target_"])
    module = cls(dict(module_cfg), full_config=cfg, device=device)
    return module, module.restore_state(manager, step=step)
