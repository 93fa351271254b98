"""Per-group optimizer bundle (port of tacorl_tpu/core/optimizers.py).

Every group (actor / q1 / q2 / log_alpha / log_alpha_prime /
action_decoder) owns its parameters and one torch Adam with optax.adam's
defaults (b1 0.9, b2 0.999, eps 1e-8), optionally behind global-norm
clipping, ``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))``.
A group steps on the gradients it is handed, so a loss reaches only the
group its gradients were taken for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import Tensor

__all__ = ["GroupOptimizer", "clip_by_global_norm", "global_norm"]


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """optax.global_norm: the l2 norm over all leaves."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> List[Tensor]:
    """optax.clip_by_global_norm, formula for formula:
    where(n < c, g, g / n * c). (``torch.nn.utils.clip_grad_norm_``
    instead scales by c / (n + 1e-6).) Stays on the device: no sync."""
    grads = list(grads)
    norm = global_norm(grads)
    clipped = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    keep = norm < max_norm
    return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]


@dataclasses.dataclass
class _Group:
    params: List[torch.nn.Parameter]
    optimizer: torch.optim.Adam
    clip: Optional[float]


class GroupOptimizer:
    """``groups``: name -> (parameters, learning rate, global-norm clip or
    None)."""

    def __init__(self, groups: Dict[str, tuple]):
        self.groups: Dict[str, _Group] = {}
        for name, (params, lr, clip) in groups.items():
            params = list(params)
            self.groups[name] = _Group(
                params,
                torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
                None if clip is None else float(clip),
            )

    def params(self, name: str) -> List[torch.nn.Parameter]:
        return self.groups[name].params

    def step_group(self, name: str, grads: Sequence[Tensor]) -> None:
        """One update of group ``name`` with ``grads``, one per parameter."""
        group = self.groups[name]
        if group.clip is not None:
            grads = clip_by_global_norm(grads, group.clip)
        for p, g in zip(group.params, grads):
            p.grad = g
        group.optimizer.step()
        for p in group.params:
            p.grad = None

    def state_dict(self) -> Dict[str, dict]:
        return {name: g.optimizer.state_dict() for name, g in self.groups.items()}

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        for name, g in self.groups.items():
            g.optimizer.load_state_dict(state[name])
