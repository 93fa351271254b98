"""Dict-of-modalities observation utilities (port of tacorl_tpu/core/obs.py;
reference: utils/misc.py:36-153): observations are nested dicts of tensors,
and every helper here maps a function over their leaves. Leaves are visited
in sorted key order, as ``jax.tree.leaves`` visits a dict's."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

__all__ = [
    "batch_size_of",
    "expand_obs",
    "flatten_obs_time",
    "unflatten_obs_time",
    "index_obs",
    "obs_map",
]


def _map(fn: Callable[[Any], Any], obs: Any) -> Any:
    if isinstance(obs, dict):
        return {k: _map(fn, v) for k, v in obs.items()}
    if isinstance(obs, (list, tuple)):
        return type(obs)(_map(fn, v) for v in obs)
    return fn(obs)


def _first_leaf(obs: Any):
    if isinstance(obs, dict):
        return _first_leaf(obs[sorted(obs)[0]])
    if isinstance(obs, (list, tuple)):
        return _first_leaf(obs[0])
    return obs


def batch_size_of(obs: Any) -> int:
    """Leading-axis size of an observation (utils/networks.py:18-29)."""
    return _first_leaf(obs).shape[0]


def expand_obs(obs: Any, n: int, reshape: bool = True) -> Any:
    """Each leaf n times along a new leading axis; with ``reshape``
    flattened to (n * bs, ...), the n copies one after the other (reference
    expand_obs, utils/misc.py:132-153)."""

    def _expand(x: torch.Tensor) -> torch.Tensor:
        out = x[None].expand((n,) + tuple(x.shape))
        if reshape:
            return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
        return out

    return _map(_expand, obs)


def flatten_obs_time(obs: Any) -> Any:
    """(B, T, ...) -> (B*T, ...) on every leaf."""
    return _map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), obs)


def unflatten_obs_time(obs: Any, batch: int, time: int) -> Any:
    return _map(lambda x: x.reshape((batch, time) + tuple(x.shape[1:])), obs)


def index_obs(obs: Any, idx) -> Any:
    """Index every leaf along the leading axis (or any tensor index)."""
    return _map(lambda x: x[idx], obs)


def obs_map(fn: Callable[[Any], Any], obs: Dict) -> Dict:
    return _map(fn, obs)
