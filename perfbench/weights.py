"""Weights made from the run's seed, on the device, in the float32 the
program trains in: one uniform draw for every random leaf, split into
leaves and scaled to +-1/sqrt(fan-in) (a bias by its layer's weight's
fan-in); LayerNorm gains 1 and shifts 0, a soft-argmax temperature 1, and
the leaves the program holds at zero, zero."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn


def _fan_in(name: str, shapes: Dict[str, torch.Size]) -> int:
    shape = shapes[name]
    if len(shape) >= 2:
        return math.prod(shape[1:])
    leaf = name.rsplit(".", 1)[-1]
    weight = name[: len(name) - len(leaf)] + leaf.replace("bias", "weight")
    return math.prod(shapes[weight][1:]) if weight in shapes else shape[0]


def make_weights(net: nn.Module, seed: int, device, held_at_zero: Callable[[str], bool]) -> Dict[str, torch.Tensor]:
    """``net``'s parameters, named as its ``state_dict``, drawn from
    ``seed`` on ``device``."""
    params = dict(net.named_parameters())
    shapes = {n: p.shape for n, p in params.items()}
    fixed = {}
    for mname, m in net.named_modules():
        if isinstance(m, nn.LayerNorm):
            fixed[f"{mname}.weight"], fixed[f"{mname}.bias"] = 1.0, 0.0
    for n in params:
        if n.endswith("temperature"):
            fixed[n] = 1.0
        elif held_at_zero(n):
            fixed[n] = 0.0
    drawn = [n for n in params if n not in fixed]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(params[n].numel() for n in drawn), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n, p in params.items():
        if n in fixed:
            out[n] = torch.full(p.shape, fixed[n], device=device)
            continue
        out[n] = flat[at:at + p.numel()].view(p.shape) / math.sqrt(_fan_in(n, shapes))
        at += p.numel()
    return out
