"""Goal-embedding MLP (port of tacorl_tpu/networks/goal_encoder.py);
state_dict keys ``mlp.{0,2,4}.*`` as in the reference."""

from __future__ import annotations

import torch.nn as nn
from torch import Tensor

from tacorl_tpu_torch.networks.layers import Activation, TorchDense, get_activation

__all__ = ["VisualGoalEncoder"]


class VisualGoalEncoder(nn.Module):
    """3-layer MLP over a concatenated goal embedding, optional LayerNorm and
    last-layer activation."""

    def __init__(
        self,
        in_features: int,
        out_features: int = 32,
        hidden_size: int = 256,
        activation_function: str = "ReLU",
        last_layer_activation: str = "Identity",
        normalize_output: bool = False,
    ):
        super().__init__()
        self.mlp = nn.Sequential(
            TorchDense(in_features, hidden_size),
            Activation(activation_function),
            TorchDense(hidden_size, hidden_size),
            Activation(activation_function),
            TorchDense(hidden_size, out_features),
        )
        self.layernorm = nn.LayerNorm(out_features, eps=1e-6) if normalize_output else None
        self.last_act = get_activation(last_layer_activation)

    def forward(self, x: Tensor) -> Tensor:
        x = self.mlp(x)
        if self.layernorm is not None:
            x = self.layernorm(x)
        return self.last_act(x)
