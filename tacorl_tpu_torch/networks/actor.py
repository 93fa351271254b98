"""Policy networks (port of the MLP policy and ``Actor.get_dist`` of
tacorl_tpu/networks/actor.py). state_dict keys follow the reference:
``policy.fc_layers.{i}``, ``policy.fc_mean``, ``policy.fc_log_std``,
``policy.gripper_action``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import TanhNormal
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
