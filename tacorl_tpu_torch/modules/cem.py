"""Cross-entropy-method action optimizer for evaluation-time planning (port
of tacorl_tpu/modules/cem.py; reference: modules/cem/cem.py:10-104, whose
q2_value defect, both values computed from q1, is not replicated).

The critic scores the whole population in one batch per iteration; the
population keeps the JAX layout, (P, B, A) flattened to (P * B, A) rows, so
a caller tiles its per-state embedding (P, 1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor

__all__ = ["cem_optimize"]


def _snap_gripper(x: Tensor) -> Tensor:
    """The last column as +-1 (>= 0 -> 1)."""
    grip = torch.where(x[..., -1:] >= 0, 1.0, -1.0).to(x.dtype)
    return torch.cat([x[..., :-1], grip], dim=-1)


def cem_optimize(
    q_fn: Callable[[Tensor], Tensor],
    initial_mean: Tensor,
    num_iterations: int = 3,
    population_size: int = 64,
    num_elites: int = 8,
    init_std: float = 0.3,
    discrete_gripper: bool = False,
    eps: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Maximize ``q_fn`` (min(Q1, Q2), folded in by the caller) over actions
    in [-1, 1]^A.

    initial_mean: (B, A), the deterministic policy action that seeds it.
    q_fn: (population_size * B, A) -> (population_size * B, 1) values.
    eps: the standard normals, (num_iterations, population_size, B, A);
    without them they are drawn from ``generator``.
    Returns the refined (B, A) mean, clipped to [-1, 1] (a discrete
    gripper's column snapped to +-1)."""
    b, a = initial_mean.shape
    shape = (num_iterations, population_size, b, a)
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=initial_mean.device)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
    eps = eps.to(initial_mean.device, initial_mean.dtype)
    mean = initial_mean
    std = torch.full_like(initial_mean, init_std)
    for it in range(num_iterations):
        population = torch.clamp(mean[None] + std[None] * eps[it], -1.0, 1.0)
        if discrete_gripper:
            population = _snap_gripper(population)
        values = q_fn(population.reshape(population_size * b, a)).reshape(population_size, b)
        elite_idx = torch.topk(values.T, num_elites, dim=1).indices  # (B, k)
        elites = torch.take_along_dim(
            population.transpose(0, 1), elite_idx[..., None], dim=1
        )  # (B, k, A)
        mean = elites.mean(dim=1)
        # jnp.std is the population std
        std = elites.std(dim=1, correction=0) + 1e-6
    if discrete_gripper:
        mean = _snap_gripper(mean)
    return torch.clamp(mean, -1.0, 1.0)
