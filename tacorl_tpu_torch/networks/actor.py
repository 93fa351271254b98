"""Policy networks (port of the MLP policy and ``Actor`` of
tacorl_tpu/networks/actor.py: ``get_dist``, ``get_actions``,
``sample_n_with_log_prob``, ``log_prob``, with the discrete Gumbel-softmax
gripper). state_dict keys follow the reference: ``policy.fc_layers.{i}``,
``policy.fc_mean``, ``policy.fc_log_std``, ``policy.gripper_action``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import (
    TanhNormal,
    gumbel_softmax_log_prob,
    gumbel_softmax_rsample,
    gumbel_softmax_sample,
)
from tacorl_tpu_torch.networks.layers import TorchDense

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -5.0
MEAN_MIN = -9.0
MEAN_MAX = 9.0

__all__ = ["Actor", "MLPPolicy"]


class MLPPolicy(nn.Module):
    """Plain MLP trunk, SiLU activations; clamped mean/log_std heads with a
    small last-layer init (U(+-init_w))."""

    def __init__(
        self,
        action_dim: int,
        input_dim: int,
        num_layers: int = 2,
        hidden_dim: int = 256,
        init_w: float = 1e-3,
        discrete_gripper: bool = False,
    ):
        super().__init__()
        self.discrete_gripper = discrete_gripper
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        cont_dim = action_dim - (1 if discrete_gripper else 0)
        dims = [input_dim] + [hidden_dim] * num_layers
        self.fc_layers = nn.ModuleList(
            TorchDense(i, o) for i, o in zip(dims[:-1], dims[1:])
        )
        self.fc_mean = TorchDense(hidden_dim, cont_dim, init_w=init_w)
        self.fc_log_std = TorchDense(hidden_dim, cont_dim, init_w=init_w)
        if discrete_gripper:
            self.gripper_action = TorchDense(hidden_dim, 2, init_w=init_w)

    def forward(self, x: Tensor):
        for fc in self.fc_layers:
            x = F.silu(fc(x))
        mean = torch.clamp(self.fc_mean(x), MEAN_MIN, MEAN_MAX)
        log_std = torch.clamp(self.fc_log_std(x), LOG_SIG_MIN, LOG_SIG_MAX)
        std = torch.exp(log_std)
        if self.discrete_gripper:
            return mean, std, self.gripper_action(x)
        return mean, std


class Actor(nn.Module):
    """Distribution-producing policy head over a trunk module."""

    def __init__(
        self,
        policy: nn.Module,
        action_dim: int,
        state_dim: int = 0,
        goal_dim: int = 0,
        discrete_gripper: bool = False,
        gumbel_temperature: float = 0.5,
    ):
        super().__init__()
        self.policy = policy
        self.action_dim = action_dim
        self.state_dim = state_dim
        self.goal_dim = goal_dim
        self.discrete_gripper = discrete_gripper
        self.gumbel_temperature = gumbel_temperature

    def forward(self, state_emb: Tensor, goal_emb: Optional[Tensor] = None):
        x = state_emb if goal_emb is None else torch.cat([state_emb, goal_emb], dim=-1)
        return self.policy(x)

    def get_dist(self, state_emb: Tensor, goal_emb: Optional[Tensor] = None) -> TanhNormal:
        out = self(state_emb, goal_emb)
        return TanhNormal(out[0], out[1])

    # The samplers take their draws as data: ``draws`` may hold ``eps``, the
    # standard normals of the continuous part, and (discrete gripper)
    # ``gumbel_u``, the uniforms on (1e-6, 1 - 1e-6) of the gripper's Gumbel
    # noise; the JAX sampler draws them from the two halves of
    # ``jax.random.split(key)`` (from ``key`` itself without a gripper).
    # What is missing is drawn from ``generator``.

    def get_actions(
        self,
        obs_emb: Tensor,
        draws: Optional[Dict[str, Tensor]] = None,
        reparameterize: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Returns sampled (actions, log_pi (..., 1)), the JAX
        ``get_actions`` branch for branch: ``reparameterize`` lets gradients
        flow through the sample, otherwise only the log-density carries
        them. (The deterministic branch waits for the rollout policies.)"""
        draws = draws or {}
        out = self(obs_emb)
        dist = TanhNormal(out[0], out[1])
        if reparameterize:
            actions, log_pi = dist.sample_and_log_prob(generator, eps=draws.get("eps"))
        else:
            value, z = dist.sample_with_pretanh(generator, eps=draws.get("eps"))
            actions = value.detach()
            log_pi = dist.log_prob(actions, z.detach())
        if not self.discrete_gripper:
            return actions, log_pi
        grip_logits = out[2]
        if reparameterize:
            onehot = gumbel_softmax_rsample(
                grip_logits, self.gumbel_temperature, hard=True,
                generator=generator, u=draws.get("gumbel_u"),
            )
            grip_idx = torch.argmax(onehot, dim=-1)
        else:
            grip_idx = gumbel_softmax_sample(grip_logits, generator, u=draws.get("gumbel_u"))
        log_pi = log_pi + gumbel_softmax_log_prob(grip_logits, grip_idx)
        grip_action = grip_idx[..., None].to(actions.dtype) * 2.0 - 1.0
        return torch.cat([actions, grip_action], dim=-1), log_pi

    def sample_n_with_log_prob(
        self,
        obs_emb: Tensor,
        n_actions: int,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """(n, bs, action_dim) actions and (n, bs, 1) log-densities; the
        draws carry a leading n axis."""
        draws = draws or {}
        out = self(obs_emb)
        dist = TanhNormal(out[0], out[1])
        actions, z = dist.sample_with_pretanh(generator, (n_actions,), eps=draws.get("eps"))
        log_pi = dist.log_prob(actions, z)
        if not self.discrete_gripper:
            return actions, log_pi
        grip_logits = out[2]
        grip_idx = gumbel_softmax_sample(
            grip_logits.expand((n_actions,) + tuple(grip_logits.shape)),
            generator, u=draws.get("gumbel_u"),
        )
        grip_action = grip_idx[..., None].to(actions.dtype) * 2.0 - 1.0
        return (
            torch.cat([actions, grip_action], dim=-1),
            log_pi + gumbel_softmax_log_prob(grip_logits, grip_idx),
        )

    def log_prob(self, obs_emb: Tensor, actions: Tensor) -> Tensor:
        """Log-density (..., 1) of given actions (the BC warm-start path);
        a gripper action in [-1, 1] maps to its class by truncation."""
        out = self(obs_emb)
        if not self.discrete_gripper:
            return TanhNormal(out[0], out[1]).log_prob(actions)
        log_pi = TanhNormal(out[0], out[1]).log_prob(actions[..., :-1])
        grip_value = actions[..., -1] / 2.0 + 0.5
        return log_pi + gumbel_softmax_log_prob(out[2], grip_value)
