"""Q-networks (port of ``MLPQNetwork`` and ``Critic`` of
tacorl_tpu/networks/critic.py): Q(s ⊕ g ⊕ a) -> scalar. state_dict keys
follow the reference: ``Q.fc_layers.{i}``, ``Q.out``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.networks.layers import TorchDense, get_activation

__all__ = ["Critic", "MLPQNetwork"]


class MLPQNetwork(nn.Module):
    """SiLU MLP trunk and a small-init (U(+-init_w)) scalar head.
    ``input_dim`` (state + goal + action) is inferred by flax in the JAX
    package and given here."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int = 256,
        num_layers: int = 2,
        last_layer_activation: str = "Identity",
        init_w: float = 1e-3,
        with_dropout: bool = False,
        dropout_p: float = 0.3,
    ):
        super().__init__()
        if with_dropout:
            raise NotImplementedError(
                "MC-dropout critics are not ported yet (see ROADMAP.md)"
            )
        dims = [input_dim] + [hidden_dim] * num_layers
        self.fc_layers = nn.ModuleList(
            TorchDense(i, o) for i, o in zip(dims[:-1], dims[1:])
        )
        self.out = TorchDense(hidden_dim, 1, init_w=init_w)
        self.last_act = get_activation(last_layer_activation)

    def forward(self, q_input: Tensor) -> Tensor:
        x = q_input
        for fc in self.fc_layers:
            x = F.silu(fc(x))
        return self.last_act(self.out(x))


class Critic(nn.Module):
    """Concatenate (obs_emb, action) and evaluate the Q trunk."""

    def __init__(
        self, q_network: nn.Module, state_dim: int = 0, goal_dim: int = 0, action_dim: int = 0
    ):
        super().__init__()
        self.Q = q_network
        self.state_dim = state_dim
        self.goal_dim = goal_dim
        self.action_dim = action_dim

    def forward(self, obs_emb: Tensor, action: Tensor) -> Tensor:
        return self.Q(torch.cat([obs_emb, action], dim=-1))
