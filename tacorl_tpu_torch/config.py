"""Config composition and instantiation (port of tacorl_tpu/config.py).

Configs are shared with the JAX package and name classes as
``_target_: tacorl_tpu.X`` (e.g. ``configs/module/play_lmp.yaml``);
``get_class`` resolves such a target to ``tacorl_tpu_torch.X`` by swapping
the package prefix, without importing the JAX package.

``compose`` is the JAX package's: named config groups composed through a
``defaults`` list, group retargeting (``- /group@target.path: option``),
``_package_: _global_`` patches, ``${a.b.c}`` interpolation and CLI-style
overrides (``a.b=value``, ``group=option``, ``+a.b=value``, ``~a.b``).
Configs are plain dicts, lists and scalars. ``yaml`` is imported only where
a file is read, so a machine without it can still import the port.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

__all__ = [
    "compose",
    "load_yaml",
    "merge",
    "resolve",
    "instantiate",
    "get_class",
    "set_by_path",
    "get_by_path",
    "MISSING",
]

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


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
    targets as they are. A JAX-package target the port has no counterpart
    for yet raises an ImportError that names it."""
    swapped = target.startswith(_JAX_PREFIX)
    name = _PORT_PREFIX + target[len(_JAX_PREFIX):] if swapped else target
    module_name, _, attr = name.rpartition(".")
    try:
        return getattr(importlib.import_module(module_name), attr)
    except (ModuleNotFoundError, AttributeError) as err:
        if not swapped:
            raise
        raise ImportError(
            f"{target!r} has no counterpart in the port yet ({name} is missing; "
            "see ROADMAP.md)"
        ) from err


# ---------------------------------------------------------------------------
# YAML io
# ---------------------------------------------------------------------------


def load_yaml(path: Union[str, Path]) -> Any:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return {} if data is None else data


# ---------------------------------------------------------------------------
# dict-path helpers
# ---------------------------------------------------------------------------


def get_by_path(cfg: Any, path: str, default: Any = KeyError) -> Any:
    node = cfg
    if path == "":
        return node
    for part in path.split("."):
        if isinstance(node, list):
            node = node[int(part)]
        elif isinstance(node, dict) and part in node:
            node = node[part]
        else:
            if default is KeyError:
                raise KeyError(f"config path not found: {path!r}")
            return default
    return node


def set_by_path(cfg: Dict, path: str, value: Any, *, merge_dicts: bool = True) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        nxt = node.get(part) if isinstance(node, dict) else None
        if not isinstance(nxt, (dict, list)):
            node[part] = {}
            nxt = node[part]
        node = nxt
    last = parts[-1]
    if (
        merge_dicts
        and isinstance(node.get(last) if isinstance(node, dict) else None, dict)
        and isinstance(value, dict)
    ):
        node[last] = merge(node[last], value)
    else:
        node[last] = value


def delete_by_path(cfg: Dict, path: str) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        node = node[part]
    node.pop(parts[-1], None)


# ---------------------------------------------------------------------------
# defaults-list composition
# ---------------------------------------------------------------------------


def _parse_default_entry(entry: Any):
    """Normalize a defaults entry to (group, option, target, absolute)."""
    if isinstance(entry, str):
        return entry, None, None, False  # "_self_" or bare group name
    if not isinstance(entry, dict) or len(entry) != 1:
        raise ValueError(f"bad defaults entry: {entry!r}")
    key, option = next(iter(entry.items()))
    absolute = key.startswith("/")
    key = key.lstrip("/")
    if "@" in key:
        group, target = key.split("@", 1)
    else:
        group, target = key, None
    return group, option, target, absolute


class _Composer:
    def __init__(self, config_dir: Union[str, Path], choices: Dict[str, str]):
        self.config_dir = Path(config_dir)
        self.choices = choices  # group-path -> option, from CLI

    def group_file(self, group: str, option: str) -> Path:
        return self.config_dir / group / f"{option}.yaml"

    def compose_file(self, path: Path, group: str = ""):
        """Compose one config file: its defaults tree, then (at the ``_self_``
        position, default last) its own body. Returns (body, package) where
        package is ``"_global_"`` for root-mounted experiment patches."""
        raw = load_yaml(path)
        if not isinstance(raw, dict):
            raise ValueError(f"{path} must contain a mapping")
        raw = dict(raw)
        pkg = raw.pop("_package_", None)
        defaults = raw.pop("defaults", [])

        body: Dict = {}
        self_seen = False
        for entry in defaults:
            grp, option, target, absolute = _parse_default_entry(entry)
            if grp == "_self_":
                body = merge(body, raw)
                self_seen = True
                continue
            full_group = grp if absolute or not group else f"{group}/{grp}"
            # CLI defaults-choice override wins
            option = self.choices.get(full_group, option)
            if option is None or option == "null":
                continue
            sub, sub_pkg = self.compose_file(
                self.group_file(full_group, option), group=full_group
            )
            if sub_pkg == "_global_":
                mount = "" if target is None else target
            else:
                mount = target if target is not None else grp.replace("/", ".")
            if mount in ("", "_global_"):
                body = merge(body, sub)
            else:
                patch: Dict = {}
                set_by_path(patch, mount, sub, merge_dicts=False)
                body = merge(body, patch)
        if not self_seen:
            body = merge(body, raw)
        return body, pkg

    def compose(self, name: str) -> Dict:
        return self.compose_file(self.config_dir / f"{name}.yaml")[0]


def _parse_override_value(text: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def compose(
    config_dir: Union[str, Path],
    config_name: str,
    overrides: Sequence[str] = (),
    resolve_interpolations: bool = True,
) -> Dict:
    """Compose ``<config_dir>/<config_name>.yaml`` with CLI-style overrides."""
    config_dir = Path(config_dir)
    choices: Dict[str, str] = {}
    value_overrides: List = []
    deletions: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        forced_add = ov.startswith("+")
        key, _, val = ov.lstrip("+").partition("=")
        # `group=option` is a defaults-choice override when the key names a
        # config group directory; a nonexistent option is an error, not a
        # silent value override
        if not forced_add and (config_dir / key).is_dir():
            if not (config_dir / key / f"{str(val)}.yaml").is_file():
                available = sorted(p.stem for p in (config_dir / key).glob("*.yaml"))
                raise ValueError(
                    f"config group {key!r} has no option {val!r}; "
                    f"available: {available}"
                )
            choices[key] = str(val)
        else:
            value_overrides.append((key, _parse_override_value(val)))

    cfg = _Composer(config_dir, choices).compose(config_name)
    for key, val in value_overrides:
        set_by_path(cfg, key, val, merge_dicts=False)
    for key in deletions:
        delete_by_path(cfg, key)
    if resolve_interpolations:
        cfg = resolve(cfg)
    return cfg


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------


def resolve(cfg: Any) -> Any:
    """Resolve ``${a.b.c}`` references against the config root."""
    import copy

    root = copy.deepcopy(cfg)

    def _resolve_value(value: Any, stack: tuple) -> Any:
        if isinstance(value, str):
            full = _INTERP_RE.fullmatch(value.strip())
            if full:
                return _lookup(full.group(1).strip(), stack)
            if _INTERP_RE.search(value):
                return _INTERP_RE.sub(
                    lambda m: str(_lookup(m.group(1).strip(), stack)), value
                )
            return value
        if isinstance(value, dict):
            return {k: _resolve_value(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [_resolve_value(v, stack) for v in value]
        return value

    def _lookup(path: str, stack: tuple) -> Any:
        if path in stack:
            raise ValueError(f"interpolation cycle at ${{{path}}}")
        return _resolve_value(get_by_path(root, path), stack + (path,))

    return _resolve_value(root, ())


# ---------------------------------------------------------------------------
# instantiation
# ---------------------------------------------------------------------------


def instantiate(cfg: Any, *args, _recursive_: Optional[bool] = None, **kwargs) -> Any:
    """Instantiate ``{'_target_': 'pkg.mod.Cls', ...}`` nodes, the target
    resolved by ``get_class`` (``tacorl_tpu.X`` -> ``tacorl_tpu_torch.X``).

    ``_recursive_`` (default True, overridable per node like Hydra's)
    controls whether nested ``_target_`` dicts are instantiated first."""
    if not isinstance(cfg, dict) or "_target_" in kwargs:
        raise TypeError("instantiate expects a dict config with _target_")
    node = dict(cfg)
    target = node.pop("_target_", None)
    if target is None:
        raise ValueError("config has no _target_")
    recursive = node.pop("_recursive_", True if _recursive_ is None else _recursive_)
    node.pop("_convert_", None)
    node.update(kwargs)
    if recursive:
        node = {k: _instantiate_children(v) for k, v in node.items()}
    fn: Callable = get_class(target)
    return fn(*args, **node)


def _instantiate_children(value: Any) -> Any:
    if isinstance(value, dict):
        if "_target_" in value:
            return instantiate(value)
        return {k: _instantiate_children(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_instantiate_children(v) for v in value]
    return value
