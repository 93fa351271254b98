"""Config helpers.

Configs are shared with the JAX package and name classes as
``_target_: tacorl_tpu.X`` (e.g. ``configs/module/play_lmp.yaml``);
``get_class`` resolves such a target to ``tacorl_tpu_torch.X`` by swapping
the package prefix, without importing the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Any

__all__ = ["get_class", "merge"]


def merge(base: dict, override: dict) -> dict:
    """Recursive dict merge; ``override`` wins, ``base`` is not modified."""
    out = dict(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = value
    return out

_JAX_PREFIX = "tacorl_tpu."
_PORT_PREFIX = "tacorl_tpu_torch."


def get_class(target: str) -> Any:
    """``tacorl_tpu.a.B`` resolves to ``tacorl_tpu_torch.a.B``; other
    targets as they are."""
    if target.startswith(_JAX_PREFIX):
        target = _PORT_PREFIX + target[len(_JAX_PREFIX):]
    module_name, _, attr = target.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)
