"""Visual encoders (port of tacorl_tpu/networks/encoders.py).

NCHW throughout. ``LMPVisionEncoder`` keeps the reference TACO-RL
state_dict layout (``model.{0,2,4}`` convs, ``model.6.temperature``,
``fc_layers.{0,3}``; with the VIB head ``fc_mean`` and ``fc_log_std`` in
their place), so released checkpoints load as they are. The other encoders
have no reference converter; their keys name the JAX package's layers
(``utils/convert.py`` maps one onto the other).

flax infers a layer's in-features from its input; torch takes them. The
image encoders read three channels (the transforms give three, depth
colorized), and ``CustomEncoder``, whose flatten width depends on the
image, takes ``input_hw``; ``networks/late_fusion.py:build_late_fusion``
fills that in from the modality's transform
(``data/transforms.py:image_sizes``).

BatchNorm (``DeepSpatialEncoder``, ``networks/resnet.py``) is flax's:
``FlaxBatchNorm`` normalizes with the batch's biased variance in train
mode and updates the running statistics with momentum 0.99; in eval mode
it uses the running statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import DiagNormal
from tacorl_tpu_torch.networks.layers import Activation, TorchConv, TorchDense, get_activation

MEAN_MIN, MEAN_MAX = -9.0, 9.0
LOG_SIG_MIN, LOG_SIG_MAX = -5.0, 2.0

__all__ = [
    "SpatialSoftArgmax",
    "LMPVisionEncoder",
    "CustomEncoder",
    "ResNetRLEncoder",
    "DeepSpatialEncoder",
    "VectorEncoder",
    "FlaxBatchNorm",
]


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


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of (N, C, H, W) float32: in
    train mode the batch's mean and biased variance (E[x^2] - E[x]^2,
    clipped at 0, flax's fast variance) normalize, and the running
    statistics move as ``r = 0.99 r + 0.01 batch``; in eval mode the
    running statistics normalize. ``nn.BatchNorm2d`` differs in the
    momentum (0.1 on the new value) and updates ``running_var`` with the
    unbiased variance. Keys: ``weight`` (flax's scale), ``bias``,
    ``running_mean``, ``running_var`` (flax's batch_stats mean, var)."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: Tensor) -> Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


class CustomEncoder(nn.Module):
    """Configurable conv stack (each conv followed by the activation and,
    with ``max_pool``, a 2x2 max-pool), flattened in (h, w, c) order as the
    JAX package's NHWC flatten, then an FC head: ``fc1`` -> activation ->
    dropout -> ``fc2`` (-> ``layernorm`` with ``normalize_output``), or with
    ``vib`` the VIB head ``fc_mean`` / ``fc_log_std``, whose forward returns
    a reparameterised sample (``eps`` optional, else drawn from
    ``generator``; the JAX encoder draws it from its ``"sample"`` rng).
    ``input_hw`` is the image's (H, W), which fixes the flatten width."""

    def __init__(
        self,
        latent_dim: int = 32,
        conv_channels: Sequence[int] = (32, 64, 64),
        kernel_sizes: Sequence[int] = (8, 4, 3),
        strides: Sequence[int] = (4, 2, 1),
        paddings: Sequence[int] = (0, 0, 0),
        hidden_dim: int = 256,
        activation_function: str = "ReLU",
        dropout: float = 0.0,
        max_pool: bool = False,
        normalize_output: bool = False,
        vib: bool = False,
        compute_dtype="bfloat16",
        input_hw: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        if input_hw is None:
            raise ValueError(
                "CustomEncoder needs input_hw, the image size its modality's "
                "transform gives (transforms.<modality>.size)"
            )
        self.latent_dim = latent_dim
        self.vib = vib
        self.max_pool = max_pool
        self.act = get_activation(activation_function)
        convs, (h, w), c = [], tuple(int(v) for v in input_hw), 3
        for ch, k, st, p in zip(conv_channels, kernel_sizes, strides, paddings):
            convs.append(TorchConv(c, ch, k, st, padding=p, dtype=compute_dtype))
            h, w, c = _out_size(h, k, st, p), _out_size(w, k, st, p), ch
            if max_pool:
                h, w = h // 2, w // 2
        if min(h, w) <= 0:
            raise ValueError(f"CustomEncoder conv stack collapsed to {(h, w)} on a {tuple(input_hw)} image")
        self.convs = nn.ModuleList(convs)
        flat = h * w * c
        if vib:
            self.fc_mean = TorchDense(flat, latent_dim)
            self.fc_log_std = TorchDense(flat, latent_dim)
        else:
            self.fc1 = TorchDense(flat, hidden_dim)
            self.drop = nn.Dropout(dropout)
            self.fc2 = TorchDense(hidden_dim, latent_dim)
        self.layernorm = nn.LayerNorm(latent_dim, eps=1e-6) if normalize_output and not vib else None

    def forward(
        self, x: Tensor, eps: Optional[Tensor] = None, generator: Optional[torch.Generator] = None
    ) -> Tensor:
        for conv in self.convs:
            x = self.act(conv(x))
            if self.max_pool:
                x = F.max_pool2d(x, 2, 2)
        x = x.float().permute(0, 2, 3, 1).flatten(1)
        if self.vib:
            mean = torch.clamp(self.fc_mean(x), MEAN_MIN, MEAN_MAX)
            log_std = torch.clamp(self.fc_log_std(x), LOG_SIG_MIN, LOG_SIG_MAX)
            return DiagNormal(mean, torch.exp(log_std)).sample(generator, eps=eps)
        x = self.fc2(self.drop(self.act(self.fc1(x))))
        return x if self.layernorm is None else self.layernorm(x)


class _ResidualBlock(nn.Module):
    """act -> 3x3 conv (padding 1) -> act -> 1x1 conv, no biases, added to
    the input."""

    def __init__(self, hidden_channels: int, residual_hidden_channels: int,
                 activation_function: str = "ReLU", compute_dtype="bfloat16"):
        super().__init__()
        self.act = get_activation(activation_function)
        self.conv1 = TorchConv(hidden_channels, residual_hidden_channels, 3, 1, padding=1,
                               use_bias=False, dtype=compute_dtype)
        self.conv2 = TorchConv(residual_hidden_channels, hidden_channels, 1, 1, use_bias=False,
                               dtype=compute_dtype)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv2(self.act(self.conv1(self.act(x))))
        return x + h


class ResNetRLEncoder(nn.Module):
    """Downsampling convs (4/2 and 4/2 with padding 1, then 3/1 with
    padding 1), a VQ-VAE-style residual stack, the activation, a spatial
    soft-argmax with a learned temperature, ``fc`` to the latent (->
    ``layernorm`` with ``normalize_output``)."""

    def __init__(
        self,
        latent_dim: int = 32,
        hidden_channels: int = 128,
        num_residual_blocks: int = 3,
        residual_hidden_channels: int = 64,
        activation_function: str = "ReLU",
        normalize_output: bool = False,
        compute_dtype="bfloat16",
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.act = get_activation(activation_function)
        ch = hidden_channels
        self.conv1 = TorchConv(3, ch // 2, 4, 2, padding=1, dtype=compute_dtype)
        self.conv2 = TorchConv(ch // 2, ch, 4, 2, padding=1, dtype=compute_dtype)
        self.conv3 = TorchConv(ch, ch, 3, 1, padding=1, dtype=compute_dtype)
        self.res_blocks = nn.ModuleList(
            _ResidualBlock(ch, residual_hidden_channels, activation_function, compute_dtype)
            for _ in range(num_residual_blocks)
        )
        self.ssam = SpatialSoftArgmax()
        self.fc = TorchDense(2 * ch, latent_dim)
        self.layernorm = nn.LayerNorm(latent_dim, eps=1e-6) if normalize_output else None

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv3(self.act(self.conv2(self.act(self.conv1(x)))))
        for block in self.res_blocks:
            x = block(x)
        x = self.fc(self.ssam(self.act(x).float()))
        return x if self.layernorm is None else self.layernorm(x)


class DeepSpatialEncoder(nn.Module):
    """Levine et al.'s deep spatial autoencoder backbone: convs 64 7/2,
    32 5/1, 16 5/1 (VALID), each followed by a ``FlaxBatchNorm`` (with
    ``use_batch_norm``) and the activation, then a spatial soft-argmax:
    latent_dim 32 (= 2 x 16 channels)."""

    latent_dim = 32

    def __init__(
        self,
        temperature: Optional[float] = None,
        normalize: bool = False,
        activation_function: str = "ReLU",
        use_batch_norm: bool = True,
        compute_dtype="bfloat16",
    ):
        super().__init__()
        self.act = get_activation(activation_function)
        specs, c = ((64, 7, 2), (32, 5, 1), (16, 5, 1)), 3
        convs = []
        for ch, k, st in specs:
            convs.append(TorchConv(c, ch, k, st, dtype=compute_dtype))
            c = ch
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(FlaxBatchNorm(ch) for ch, _, _ in specs) if use_batch_norm else None
        self.ssam = SpatialSoftArgmax(temperature, normalize)

    def forward(self, x: Tensor) -> Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.bns is not None:
                x = self.bns[i](x.float())
            x = self.act(x)
        return self.ssam(x.float())


class VectorEncoder(nn.Module):
    """Identity for a vector modality without ``hidden`` layers, else an
    MLP (``fc_layers``: the hidden layers with the activation, then the
    latent layer); ``in_features``, the vector's width, is needed then."""

    def __init__(
        self,
        latent_dim: int,
        hidden: Sequence[int] = (),
        activation_function: str = "ReLU",
        in_features: Optional[int] = None,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.act = get_activation(activation_function)
        if hidden and in_features is None:
            raise ValueError("VectorEncoder with hidden layers needs in_features")
        dims = [in_features] + list(hidden) + [latent_dim] if hidden else []
        self.fc_layers = nn.ModuleList(TorchDense(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: Tensor) -> Tensor:
        if not len(self.fc_layers):
            return x
        for fc in self.fc_layers[:-1]:
            x = self.act(fc(x))
        return self.fc_layers[-1](x)
