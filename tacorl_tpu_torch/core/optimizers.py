"""Per-group optimizer bundle (port of tacorl_tpu/core/optimizers.py).

Every group (actor / q1 / q2 / log_alpha / log_alpha_prime /
action_decoder) owns its parameters and one torch Adam with optax.adam's
defaults (b1 0.9, b2 0.999, eps 1e-8), optionally behind global-norm
clipping, ``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))``.
A group steps on the gradients it is handed, so a loss reaches only the
group its gradients were taken for. Under a process group the gradients
are first averaged over the dp ranks (``parallel/mesh.py:all_reduce_mean``,
one collective a group, before the clip, so the clip sees the global
gradient); ``reduce_gradients`` does the same for a plain optimizer's
``.grad`` before its gradient norm and step. The global norm of a group
with mp-sharded parameters sums their squares over the mp group.

``set_capturable`` switches any of the port's optimizers between the eager
mode and ``capturable=True``, the mode a CUDA graph of the train step needs
(``core/graphs.py``): the step counts move to the device, and the bias
corrections are computed there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import Tensor

from tacorl_tpu_torch.parallel.mesh import all_reduce_mean, shard_of

__all__ = [
    "GroupOptimizer", "clip_by_global_norm", "global_norm", "reduce_gradients", "set_capturable",
    "torch_optimizers",
]


def global_norm(tensors: Sequence[Tensor], params: Optional[Sequence[Tensor]] = None) -> Tensor:
    """optax.global_norm: the l2 norm over all leaves. ``params``, one a
    tensor, say which tensors are mp shards
    (``parallel/tensor_parallel.py:shard_of``): their sum of squares is
    summed over the mp group before the root, so the norm is the whole
    tree's, as XLA computes it over sharded leaves."""
    tensors = list(tensors)
    shards = [shard_of(p) for p in params] if params is not None else []
    if not any(s is not None for s in shards):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    whole = [t for t, s in zip(tensors, shards) if s is None]
    parts = [t for t, s in zip(tensors, shards) if s is not None]
    sq = torch.stack(torch._foreach_norm(parts)).square().sum()
    dist.all_reduce(sq, group=next(s for s in shards if s is not None).mesh.mp_group)
    if whole:
        sq = sq + torch.stack(torch._foreach_norm(whole)).square().sum()
    return torch.sqrt(sq)


def clip_by_global_norm(
    grads: Sequence[Tensor], max_norm: float, params: Optional[Sequence[Tensor]] = None
) -> List[Tensor]:
    """optax.clip_by_global_norm, formula for formula:
    where(n < c, g, g / n * c). (``torch.nn.utils.clip_grad_norm_``
    instead scales by c / (n + 1e-6).) Stays on the device: no sync.
    ``params`` as in ``global_norm``."""
    grads = list(grads)
    norm = global_norm(grads, params)
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
        """One update of group ``name`` with ``grads``, one per parameter
        (averaged over the dp ranks first)."""
        group = self.groups[name]
        grads = all_reduce_mean(grads)
        if group.clip is not None:
            grads = clip_by_global_norm(grads, group.clip, group.params)
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


def reduce_gradients(params) -> List[Tensor]:
    """Each parameter's ``.grad`` averaged over the dp ranks, in place (one
    collective a dtype); returns the gradients that exist."""
    return all_reduce_mean([p.grad for p in params if p.grad is not None])


def torch_optimizers(optimizer) -> List[torch.optim.Optimizer]:
    """The torch optimizers of a train state's ``optimizer``: itself, or a
    ``GroupOptimizer``'s one per group."""
    if isinstance(optimizer, GroupOptimizer):
        return [g.optimizer for g in optimizer.groups.values()]
    return [optimizer]


def set_capturable(optimizer, capturable: bool) -> None:
    """Every param group's ``capturable`` flag, with each step count moved
    where that mode keeps it: a float32 device tensor beside its parameter,
    or a CPU tensor. A state dict of either mode loads into the other: call
    this after loading it."""
    for opt in torch_optimizers(optimizer):
        for group in opt.param_groups:
            group["capturable"] = capturable
        for p, state in opt.state.items():
            step = state.get("step")
            if torch.is_tensor(step):
                state["step"] = (
                    step.to(device=p.device, dtype=torch.float32) if capturable
                    else torch.tensor(float(step), dtype=torch.float32)
                )
