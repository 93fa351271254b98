"""ResNet-18 encoders (port of tacorl_tpu/networks/resnet.py): a ResNet-18
backbone, global average pool and a latent head, and R3M's frozen
backbone with a trainable MLP head.

R3M (Nair et al., CoRL 2022, github.com/facebookresearch/r3m
``r3m/models/models_r3m.py``) publishes the backbone as torchvision's
``resnet18`` with its ``fc`` replaced by the identity, taking frames in
[0, 1] normalised by ImageNet's mean and standard deviation inside the
model. ``R3MEncoder(r3m_trunk=True)`` is that trunk; its default keeps
the JAX package's layout (a frozen 512 -> 512 ``backbone.fc``, frames as
the transforms leave them).

Keys are torchvision's ``resnet18`` (``conv1``, ``bn1``,
``layer{n}.{b}.conv1`` / ``bn1`` / ``conv2`` / ``bn2``,
``layer{n}.{b}.downsample.0`` / ``.1``, ``fc``), so a torchvision-layout
state dict loads (its 1000-way ``fc`` only into ``latent_dim=1000``). No
pretrained weights ship: the init is the JAX package's (flax's
lecun-normal convs, BatchNorm scale 1 and bias 0, the head uniform).
BatchNorm is ``networks/encoders.py:FlaxBatchNorm`` (flax's momentum and
biased variance). Convolutions run in ``compute_dtype`` (bfloat16 by
default) with no bias; BatchNorm and everything after it in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.networks.encoders import FlaxBatchNorm
from tacorl_tpu_torch.networks.layers import TorchConv, TorchDense, lecun_normal_
from tacorl_tpu_torch.ops.device_span import backbone_span
from tacorl_tpu_torch.utils import profiling

__all__ = ["ResNet18Encoder", "R3MEncoder", "IMAGENET_MEAN", "IMAGENET_STD"]

# torchvision's ImageNet normalisation, which R3M applies inside its model
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _Conv(TorchConv):
    """A bias-free conv with padding k // 2 and flax's nn.Conv init."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int, dtype):
        super().__init__(in_channels, features, kernel, stride, padding=kernel // 2,
                         use_bias=False, dtype=dtype)

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight, self.in_channels * self.kernel_size[0] * self.kernel_size[1])


class _BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int, dtype):
        super().__init__()
        self.conv1 = _Conv(in_channels, features, 3, stride, dtype)
        self.bn1 = FlaxBatchNorm(features)
        self.conv2 = _Conv(features, features, 3, 1, dtype)
        self.bn2 = FlaxBatchNorm(features)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = nn.Sequential(_Conv(in_channels, features, 1, stride, dtype),
                                            FlaxBatchNorm(features))

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18Encoder(nn.Module):
    """Stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max-pool), stages of basic
    blocks (``stage_sizes`` blocks each, ``width * 2**stage`` channels,
    stride 2 at the first block of every stage after the first), global
    average pool, ``fc`` to the latent: (N, C, H, W) -> (N, latent_dim).
    ``latent_dim=None``: no ``fc``, the pooled features are the output
    (``latent_dim`` becomes their width)."""

    def __init__(
        self,
        latent_dim: Optional[int] = 32,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        width: int = 64,
        compute_dtype="bfloat16",
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_stages = len(stage_sizes)
        self.conv1 = _Conv(3, width, 7, 2, compute_dtype)
        self.bn1 = FlaxBatchNorm(width)
        c = width
        for stage, n_blocks in enumerate(stage_sizes):
            features = width * 2**stage
            blocks = []
            for block in range(n_blocks):
                blocks.append(_BasicBlock(c, features, 2 if stage > 0 and block == 0 else 1, compute_dtype))
                c = features
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        if latent_dim is None:
            self.latent_dim, self.fc = c, None
        else:
            self.fc = TorchDense(c, latent_dim)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.float().mean(dim=(2, 3))
        return x if self.fc is None else self.fc(x)


class R3MEncoder(nn.Module):
    """A frozen ResNet-18 backbone (``backbone.*``: no gradient, and
    eval-mode BatchNorm statistics in train mode too) and a trainable head
    ``head1`` -> ReLU -> ``head2``.

    By default the backbone ends in a frozen ``fc`` to ``backbone_latent``
    features and takes frames as the transforms leave them (the JAX
    package's layout). ``r3m_trunk``: R3M's trunk, with no ``fc``, so the
    pooled features (``width * 8``, 512 for R3M) go to ``head1``, and
    frames in [-1, 1] (the transforms' normalize) mapped back to [0, 1] and
    normalised by ImageNet's mean and standard deviation before the first
    convolution, as R3M's model does. ``width``, ``stage_sizes`` and
    ``compute_dtype`` are the backbone's (``ResNet18Encoder``).

    The backbone's forward is the span ``encoder/backbone`` (a profiler
    range, a ``RECORDER`` span and, on the card, the device span
    ``encoder_backbone``, whose marker kernels a graph replay keeps,
    launched on every step), and
    the counter ``encoder/backbone_frames`` is the frames it took."""

    def __init__(
        self,
        latent_dim: int = 32,
        hidden_dim: int = 256,
        backbone_latent: int = 512,
        width: int = 64,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        compute_dtype="bfloat16",
        r3m_trunk: bool = False,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.backbone = ResNet18Encoder(
            latent_dim=None if r3m_trunk else backbone_latent, stage_sizes=stage_sizes, width=width,
            compute_dtype=compute_dtype,
        )
        self.backbone.requires_grad_(False)
        self.backbone.eval()
        self.r3m_trunk = r3m_trunk
        if r3m_trunk:
            # ((x + 1) / 2 - mean) / std as (x - (2 mean - 1)) / (2 std)
            shift = torch.tensor([2.0 * m - 1.0 for m in IMAGENET_MEAN]).view(1, 3, 1, 1)
            scale = torch.tensor([2.0 * s for s in IMAGENET_STD]).view(1, 3, 1, 1)
            self.register_buffer("input_shift", shift, persistent=False)
            self.register_buffer("input_scale", scale, persistent=False)
        self.head1 = TorchDense(self.backbone.latent_dim, hidden_dim)
        self.head2 = TorchDense(hidden_dim, latent_dim)

    def train(self, mode: bool = True) -> "R3MEncoder":
        super().train(mode)
        self.backbone.eval()
        return self

    def forward(self, x: Tensor) -> Tensor:
        with record_function("encoder/backbone"), profiling.spans("encoder/backbone"), \
                backbone_span(x.device), torch.no_grad():
            profiling.count("encoder/backbone_frames", x.shape[0])
            if self.r3m_trunk:
                x = (x.float() - self.input_shift) / self.input_scale
            feats = self.backbone(x)
        return self.head2(F.relu(self.head1(feats)))
