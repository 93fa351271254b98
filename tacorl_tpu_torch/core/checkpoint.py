"""Checkpoint store (port of ``CheckpointManager`` and
``load_module_from_checkpoint`` of tacorl_tpu/core/checkpoint.py), in the
port's own format:

    <dir>/config.json               experiment config (round-trip record)
    <dir>/ckpts/<step>/state.pt     torch.save of TrainState.state_dict():
                                    step, the net's state_dict (the
                                    reference layout) and the optimizer's
    <dir>/ckpts/metrics.json        step -> monitored metric

Under a process group rank 0 alone writes (the config, each save, the
metrics file, and retention's deletions; a save of an mp-sharded state
holds the full tensors, which every rank gathers first: ``TrainState``)
and every rank waits at a barrier after a save, so every rank can restore
it; every rank keeps the same scores in memory, so ``best_step`` agrees.

Retention is the JAX package's: at most ``max_to_keep`` saves, the latest
always kept, the rest the best by ``monitor`` (``mode`` max or min). A save
without the metric scores NaN, which ranks last in max mode and, as in the
JAX package, first in min mode (ROADMAP Queue 3).

Param-tree surgery (``graft``, ``freeze_mask``, the JAX package's) works on
the port's state_dict layout: flat dicts of dotted keys, where a prefix
names a sub-tree (``"actor.goal_encoder"`` is JAX's
``"actor/goal_encoder"``). The port's modules graft with
``load_state_dict`` and freeze with ``requires_grad_``
(``modules/tacorl.py``); these are library functions.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from tacorl_tpu_torch.config import get_class, merge
from tacorl_tpu_torch.parallel.mesh import barrier, rank

__all__ = ["CheckpointManager", "freeze_mask", "graft", "load_module_from_checkpoint"]


class CheckpointManager:
    def __init__(
        self,
        directory: Union[str, Path],
        max_to_keep: int = 3,
        monitor: Optional[str] = None,
        mode: str = "max",
        config: Optional[dict] = None,
    ):
        self.dir = Path(directory).expanduser()
        self.ckpt_dir = self.dir / "ckpts"
        self.is_main = rank() == 0
        if self.is_main:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep
        self._metrics_file = self.ckpt_dir / "metrics.json"
        self._metrics: Dict[str, float] = (
            json.loads(self._metrics_file.read_text())
            if self._metrics_file.is_file()
            else {}
        )
        if config is not None and self.is_main:
            (self.dir / "config.json").write_text(json.dumps(config, indent=1))
        barrier()

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / str(step) / "state.pt"

    def save(
        self, step: int, state: Any, metrics: Optional[Dict[str, float]] = None
    ) -> None:
        """``state`` is a TrainState (or anything with ``state_dict``);
        ``metrics`` may hold the monitored value of this save. Every rank
        calls it: an mp-sharded state gathers its shards first."""
        sd = state.state_dict()
        if self.is_main:
            path = self._path(step)
            path.parent.mkdir(parents=True, exist_ok=True)
            partial = path.with_suffix(".tmp")
            torch.save(sd, partial)
            partial.replace(path)
        if metrics and self.monitor and self.monitor in metrics:
            self._metrics[str(step)] = float(metrics[self.monitor])
        else:
            self._metrics.setdefault(str(step), float("nan"))
        self._retention()
        if self.is_main:
            self._metrics_file.write_text(json.dumps(self._metrics))
        barrier()

    def _retention(self) -> None:
        steps = sorted(int(s) for s in self._metrics)
        if len(steps) <= self.max_to_keep:
            return
        last = steps[-1]  # always keep the latest (save_last semantics)
        candidates = steps[:-1]
        if self.monitor:
            sign = 1.0 if self.mode == "max" else -1.0

            def score(s):
                v = self._metrics[str(s)]
                return sign * (v if math.isfinite(v) else -math.inf)

            candidates.sort(key=score, reverse=True)
        keep = set(candidates[: self.max_to_keep - 1]) | {last}
        for s in steps:
            if s not in keep:
                if self.is_main:
                    shutil.rmtree(self._path(s).parent, ignore_errors=True)
                self._metrics.pop(str(s), None)

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name) for p in self.ckpt_dir.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / "state.pt").is_file()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The kept step with the best finite monitored value, else the
        latest."""
        scored = {int(s): v for s, v in self._metrics.items() if math.isfinite(v)}
        if not scored:
            return self.latest_step()
        fn = max if self.mode == "max" else min
        return fn(scored, key=scored.get)

    def restore(
        self,
        step: Union[int, str, None] = None,
        map_location: Union[str, torch.device] = "cpu",
    ) -> Dict[str, Any]:
        """The saved state dict of ``step``: ``"best"`` for ``best_step``,
        the latest when None or < 0."""
        if step == "best":
            step = self.best_step()
        elif step is None or step < 0:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def load_config(self) -> dict:
        return json.loads((self.dir / "config.json").read_text())


def load_module_from_checkpoint(
    directory: Union[str, Path],
    step: Union[int, str] = -1,
    overwrite_cfg: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
):
    """Re-instantiate a port module from the config saved beside its
    checkpoints (its ``module`` entry, or the whole config; ``_target_:
    tacorl_tpu.X`` resolves to the port's class) on ``device`` and restore
    its state (``step``: an int, -1 for the latest, or ``"best"``: ranked
    by the run's ``ckpt_mode``, "min" when the config has none, as
    ``python -m tacorl_tpu_torch.train`` defaults it; the JAX package ranks
    by "max" here whatever the run monitored). ``overwrite_cfg`` overrides
    keys of the module config. Returns (module, state)."""
    manager = CheckpointManager(directory)
    cfg = manager.load_config()
    manager.mode = cfg.get("ckpt_mode", "min")
    if overwrite_cfg:
        cfg = merge(cfg, {"module": overwrite_cfg} if "module" in cfg else overwrite_cfg)
    module_cfg = cfg["module"] if "module" in cfg else cfg
    cls = get_class(module_cfg["_target_"])
    module = cls(dict(module_cfg), full_config=cfg, device=device)
    return module, module.restore_state(manager, step=step)


# -- param-tree surgery --------------------------------------------------------------


def _subtree(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries under ``prefix`` keyed by the rest of their key (the
    prefix itself, a leaf, as "")."""
    return {
        k[len(prefix) + 1:]: v for k, v in state.items() if k == prefix or k.startswith(prefix + ".")
    }


def graft(target: Dict[str, Any], source: Dict[str, Any], mapping: Dict[str, str]) -> Dict[str, Any]:
    """A copy of ``target`` with source sub-trees copied in. ``mapping``:
    target prefix -> source prefix. A missing prefix raises KeyError; two
    sub-trees of other keys, or a tensor of another rank, raise ValueError,
    as the JAX package's structure check does."""
    out = {k: v.clone() if torch.is_tensor(v) else v for k, v in target.items()}
    for dst, src in mapping.items():
        sub, ref = _subtree(source, src), _subtree(out, dst)
        if not sub:
            raise KeyError(src)
        if not ref:
            raise KeyError(dst)
        if set(sub) != set(ref) or any(sub[k].dim() != ref[k].dim() for k in ref):
            raise ValueError(f"graft structure mismatch at {dst!r} <- {src!r}")
        for k, v in sub.items():
            out[f"{dst}.{k}" if k else dst] = v.clone()
    return out


def freeze_mask(params: Dict[str, Any], frozen_prefixes: List[str]) -> Dict[str, bool]:
    """Key -> trainable: False under any frozen prefix, else True."""
    return {
        k: not any(k == p or k.startswith(p + ".") for p in frozen_prefixes) for k in params
    }
