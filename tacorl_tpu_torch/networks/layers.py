"""Shared layer primitives (port of tacorl_tpu/networks/layers.py).

``TorchDense`` / ``TorchConv`` are ``nn.Linear`` / ``nn.Conv2d`` with the
JAX package's initialization: weight and bias ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)), or U(-init_w, init_w) for small output heads. Both keep
torch's ``weight`` / ``bias`` state_dict keys. ``dtype`` is the compute
dtype: inputs and the weight are cast to it (bf16 in the vision encoder)
and the float32 bias is added after, as the JAX layers do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

__all__ = [
    "TorchDense",
    "TorchConv",
    "Activation",
    "get_activation",
    "resolve_dtype",
    "lecun_normal_",
    "MLP",
    "reset_parameters",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """None, a torch dtype, or its name ("bfloat16") -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return _DTYPES[name]


def get_activation(name: str) -> Callable[[Tensor], Tensor]:
    """Map the reference's torch.nn activation names onto functions."""
    table = {
        "ReLU": F.relu,
        "SiLU": F.silu,
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
        "ELU": F.elu,
        "Tanh": torch.tanh,
        "LeakyReLU": F.leaky_relu,
        "Sigmoid": torch.sigmoid,
        "Identity": lambda x: x,
        "Softplus": F.softplus,
        "Mish": F.mish,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


class Activation(nn.Module):
    """A named activation as a parameter-free module (keeps the reference's
    ``nn.Sequential`` indices, e.g. ``model.{0,2,4}`` for the convs)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_activation(name)

    def forward(self, x: Tensor) -> Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


def lecun_normal_(tensor: Tensor, fan_in: int) -> Tensor:
    """flax's lecun_normal / default embedding init: truncated normal at
    +-2 sigma, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std)


def reset_parameters(module: nn.Module) -> None:
    """Re-initialize every layer of ``module`` from torch's global RNG,
    children first, so a layer that overrides its sublayers' init
    (attention, position embeddings) has the last word."""
    for m in reversed(list(module.modules())):
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()


class TorchDense(nn.Linear):
    """Linear layer with the JAX package's init (U(+-1/sqrt(in)) or
    U(+-init_w))."""

    def __init__(
        self,
        in_features: int,
        features: int,
        init_w: Optional[float] = None,
        use_bias: bool = True,
        dtype=None,
    ):
        self.init_w = init_w
        self.compute_dtype = resolve_dtype(dtype)
        super().__init__(in_features, features, bias=use_bias)

    def reset_parameters(self) -> None:
        bound = self.init_w if self.init_w is not None else 1.0 / math.sqrt(self.in_features)
        nn.init.uniform_(self.weight, -bound, bound)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: Tensor) -> Tensor:
        cd = self.compute_dtype
        w = self.weight if cd is None else self.weight.to(cd)
        y = F.linear(x.to(w.dtype), w)
        return y if self.bias is None else y + self.bias


class TorchConv(nn.Conv2d):
    """NCHW conv with the JAX package's init (U(+-1/sqrt(fan_in)));
    VALID padding by default."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Union[int, Tuple[int, int]],
        strides: Union[int, Tuple[int, int]] = 1,
        padding: int = 0,
        use_bias: bool = True,
        dtype=None,
    ):
        self.compute_dtype = resolve_dtype(dtype)
        super().__init__(
            in_channels, features, kernel_size, stride=strides, padding=padding,
            bias=use_bias,
        )

    def reset_parameters(self) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(self.weight, -bound, bound)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: Tensor) -> Tensor:
        cd = self.compute_dtype
        w = self.weight if cd is None else self.weight.to(cd)
        y = F.conv2d(x.to(w.dtype), w, None, self.stride, self.padding)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


class MLP(nn.Module):
    """Simple MLP trunk: hidden sizes + activation, optional final layer."""

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int],
        activation: str = "ReLU",
        out_features: Optional[int] = None,
        out_init_w: Optional[float] = None,
        activate_last: bool = False,
    ):
        super().__init__()
        self.act = get_activation(activation)
        dims = [in_features] + list(hidden)
        self.hidden = nn.ModuleList(
            TorchDense(i, o) for i, o in zip(dims[:-1], dims[1:])
        )
        self.out = (
            TorchDense(dims[-1], out_features, init_w=out_init_w)
            if out_features is not None
            else None
        )
        self.activate_last = activate_last

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.hidden:
            x = self.act(layer(x))
        if self.out is not None:
            x = self.out(x)
            if self.activate_last:
                x = self.act(x)
        return x
