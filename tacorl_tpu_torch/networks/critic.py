"""Q-networks (port of ``MLPQNetwork``, ``D2RLQNetwork``,
``DenseNetQNetwork`` and ``Critic`` of tacorl_tpu/networks/critic.py):
Q(s ⊕ g ⊕ a) -> scalar over an MLP, D2RL or DenseNet trunk
(``networks/layers.py:Trunk``, the policies' trunk). state_dict keys follow the
reference: ``Q.fc_layers.{i}``, ``Q.out``.

MC-dropout critics (``with_dropout``, the uncertainty-gated horizon
curriculum's requirement) keep dropout active in every forward, train or
eval, between the trunk and ``out``, as the JAX package's
``nn.Dropout(deterministic=False)`` does. The keep mask (boolean, the
trunk output's shape) is an optional input; without one it is drawn from
the ``generator`` given, and without a generator it is a fixed mask (a
generator seeded 0), as the JAX package's default dropout key
``jax.random.key(0)`` gives a fixed mask. Dropout adds no parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch import Tensor

from tacorl_tpu_torch.networks.layers import TorchDense, Trunk, get_activation
from tacorl_tpu_torch.parallel.mesh import draw_rows

__all__ = ["Critic", "MLPQNetwork", "D2RLQNetwork", "DenseNetQNetwork", "dropout_keep_mask"]


def dropout_keep_mask(
    shape, p: float, device, generator: Optional[torch.Generator] = None
) -> Tensor:
    """A boolean keep mask, each element kept with probability 1 - p; from
    a generator seeded 0 when none is given. The rows are the axis before
    the last (``parallel.mesh.draw_rows``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    keep = draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape, len(shape) - 2)
    return keep < 1.0 - p


class MLPQNetwork(nn.Module):
    """SiLU MLP trunk and a small-init (U(+-init_w)) scalar head.
    ``input_dim`` (state + goal + action) is inferred by flax in the JAX
    package and given here. An MC-dropout mask covers the trunk's whole
    output, ``trunk_dim`` wide."""

    trunk_kind = "mlp"

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
        self.with_dropout = bool(with_dropout)
        self.dropout_p = float(dropout_p)
        self.hidden_dim = hidden_dim
        self.fc_layers = Trunk(self.trunk_kind, input_dim, hidden_dim, num_layers)
        self.trunk_dim = self.fc_layers.out_dim
        self.out = TorchDense(self.trunk_dim, 1, init_w=init_w)
        self.last_act = get_activation(last_layer_activation)

    def forward(
        self,
        q_input: Tensor,
        mask: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        x = self.fc_layers(q_input)
        if self.with_dropout:
            if mask is None:
                mask = dropout_keep_mask(x.shape, self.dropout_p, x.device, generator)
            # flax's Dropout: select(keep, x / keep_prob, 0)
            x = torch.where(mask, x / (1.0 - self.dropout_p), torch.zeros_like(x))
        return self.last_act(self.out(x))


class D2RLQNetwork(MLPQNetwork):
    """Input-skip trunk (``D2RLPolicy``'s)."""

    trunk_kind = "d2rl"


class DenseNetQNetwork(MLPQNetwork):
    """Dense-concatenation trunk (``DenseNetPolicy``'s), ``input +
    num_layers * hidden`` wide."""

    trunk_kind = "densenet"


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

    def forward(
        self,
        obs_emb: Tensor,
        action: Tensor,
        mask: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        """``mask`` and ``generator`` reach an MC-dropout trunk; a trunk
        without dropout takes neither."""
        q_input = torch.cat([obs_emb, action], dim=-1)
        if getattr(self.Q, "with_dropout", False):
            return self.Q(q_input, mask, generator)
        return self.Q(q_input)
