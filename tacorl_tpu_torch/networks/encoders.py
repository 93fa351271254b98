"""Visual encoders (port of the Play-LMP encoder of
tacorl_tpu/networks/encoders.py).

NCHW throughout. ``LMPVisionEncoder`` keeps the reference TACO-RL
state_dict layout (``model.{0,2,4}`` convs, ``model.6.temperature``,
``fc_layers.{0,3}``; with the VIB head ``fc_mean`` and ``fc_log_std`` in
their place), so released checkpoints load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch import Tensor

from tacorl_tpu_torch.core.distributions import DiagNormal
from tacorl_tpu_torch.networks.layers import Activation, TorchConv, TorchDense

MEAN_MIN, MEAN_MAX = -9.0, 9.0
LOG_SIG_MIN, LOG_SIG_MAX = -5.0, 2.0

__all__ = ["SpatialSoftArgmax", "LMPVisionEncoder"]


def _conv_stack_size(size: int, kernels_strides) -> int:
    """Spatial size after VALID convs; <= 0 once the stack has collapsed."""
    for k, s in kernels_strides:
        if size < k:
            return 0
        size = (size - k) // s + 1
    return size


class SpatialSoftArgmax(nn.Module):
    """Soft keypoints (N, C, H, W) -> (N, 2C), interleaved (x, y) per
    channel: a softmax over space per channel, then the expected
    coordinates. Learnable temperature when ``temperature`` is None."""

    def __init__(self, temperature: Optional[float] = None, normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        if temperature is None:
            self.temperature = nn.Parameter(torch.ones(1))
        else:
            self.register_buffer(
                "temperature", torch.tensor([float(temperature)]), persistent=False
            )

    def reset_parameters(self) -> None:
        if isinstance(self.temperature, nn.Parameter):
            nn.init.ones_(self.temperature)

    def forward(self, x: Tensor) -> Tensor:
        n, c, h, w = x.shape
        softmax = torch.softmax(x.reshape(n, c, h * w) / self.temperature, dim=-1)
        softmax = softmax.reshape(n, c, h, w)
        x_range = torch.arange(w, dtype=x.dtype, device=x.device)
        y_range = torch.arange(h, dtype=x.dtype, device=x.device)
        if self.normalize:
            x_range = (x_range / (w - 1)) * 2 - 1
            y_range = (y_range / (h - 1)) * 2 - 1
        ex = torch.einsum("nchw,w->nc", softmax, x_range)
        ey = torch.einsum("nchw,h->nc", softmax, y_range)
        return torch.stack([ex, ey], dim=-1).reshape(n, 2 * c)


class LMPVisionEncoder(nn.Module):
    """3-conv CNN (8/4, 4/2, 3/1) + SpatialSoftArgmax + FC head -> latent.

    ``compute_dtype`` (bf16 by default, as in the JAX package) is the
    convolutions' dtype; the spatial softmax and the head run in float32.

    ``vib``: the variational information bottleneck head replaces the FC
    head. ``get_dist`` is a DiagNormal with its mean clipped to [-9, 9] and
    its log std to [-5, 2]; the forward returns a reparameterised sample of
    it, ``eps`` (the standard normal) optional, else drawn from
    ``generator``.
    """

    def __init__(
        self,
        latent_dim: int = 32,
        hidden_dim: int = 256,
        activation_function: str = "ReLU",
        dropout: float = 0.0,
        temperature: Optional[float] = None,
        normalize_spatial_softmax: bool = False,
        normalize_output: bool = False,
        vib: bool = False,
        compute_dtype="bfloat16",
        in_channels: int = 3,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.vib = vib
        self.model = nn.Sequential(
            TorchConv(in_channels, 32, 8, 4, dtype=compute_dtype),
            Activation(activation_function),
            TorchConv(32, 64, 4, 2, dtype=compute_dtype),
            Activation(activation_function),
            TorchConv(64, 64, 3, 1, dtype=compute_dtype),
            Activation(activation_function),
            SpatialSoftArgmax(temperature, normalize_spatial_softmax),
        )
        if vib:
            self.fc_mean = TorchDense(2 * 64, latent_dim)
            self.fc_log_std = TorchDense(2 * 64, latent_dim)
        else:
            self.fc_layers = nn.Sequential(
                TorchDense(2 * 64, hidden_dim),
                Activation(activation_function),
                nn.Dropout(dropout),
                TorchDense(hidden_dim, latent_dim),
            )
        # the VIB head's sample is not normalised (the JAX head makes no
        # LayerNorm parameters there either)
        self.layernorm = nn.LayerNorm(latent_dim, eps=1e-6) if normalize_output and not vib else None

    def conv_forward(self, x: Tensor) -> Tensor:
        out_hw = [
            _conv_stack_size(s, ((8, 4), (4, 2), (3, 1))) for s in x.shape[-2:]
        ]
        if min(out_hw) <= 0:
            raise ValueError(
                f"LMPVisionEncoder conv stack collapsed to spatial size "
                f"{tuple(out_hw)} — input image too small for the "
                f"8/4, 4/2, 3/1 conv strides (needs >= ~48px)"
            )
        for layer in self.model[:6]:
            x = layer(x)
        return self.model[6](x.float())

    def get_dist(self, x: Tensor) -> DiagNormal:
        if not self.vib:
            raise ValueError("get_dist requires vib=True")
        feat = self.conv_forward(x)
        mean = torch.clamp(self.fc_mean(feat), MEAN_MIN, MEAN_MAX)
        log_std = torch.clamp(self.fc_log_std(feat), LOG_SIG_MIN, LOG_SIG_MAX)
        return DiagNormal(mean, torch.exp(log_std))

    def forward(
        self,
        x: Tensor,
        eps: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        if self.vib:
            return self.get_dist(x).sample(generator, eps=eps)
        out = self.fc_layers(self.conv_forward(x))
        if self.layernorm is not None:
            out = self.layernorm(out)
        return out
