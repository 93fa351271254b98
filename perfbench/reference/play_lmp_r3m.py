"""Plain PyTorch reference of the Play-LMP train step over a frozen R3M
ResNet-18 (TACO-RL's ``R3MResNet`` encoder).

The encoder of each frame is R3M's published trunk (Nair et al., CoRL 2022,
arXiv:2203.12601; github.com/facebookresearch/r3m
``r3m/models/models_r3m.py``): torchvision's ``resnet18`` with its ``fc``
replaced by the identity, under ``torch.no_grad`` (frozen), then a
trainable head ``head1`` -> ReLU -> ``head2`` (TACO-RL
``networks/visual_encoders/encoder.py`` ``R3MResNet``). The trunk, written
out with ``torch.nn.functional``: a 7x7/2 convolution (padding 3),
BatchNorm, ReLU, a 3x3/2 max-pool (padding 1), four stages of two basic
blocks at the widths of the configuration's ``backbone_widths`` (3x3
convolutions with padding 1, BatchNorm after each, a residual sum, ReLU;
the first block of each stage after the first strides 2, and its residual
goes through a 1x1/2 convolution and BatchNorm), and the global average
pool: 512 features a frame. Every convolution is bias-free; BatchNorm uses
its running statistics (eval mode), eps 1e-5. The rest of the network, the
augmentation, the draws and Adam are ``reference/play_lmp.py``'s.

Departures from R3M's published code, each to compute what the program
computes:

* R3M scales uint8 frames by 1/255 and normalises them by ImageNet's mean
  and standard deviation. Here the frames reach the encoder as the
  augmentation leaves them, in [-1, 1] ((y - 0.5) / 0.5 of y in [0, 1]), and
  the encoder computes ``(x - (2 mean - 1)) / (2 std)``, which is
  ``((x + 1) / 2 - mean) / std``: R3M's normalisation of y.
* R3M resizes a frame that is not 224x224 (Resize(256), CenterCrop(224)).
  Here the augmentation's bilinear resize gives 224x224 frames and the DrQ
  shift and colour jitter follow, as the program's transforms do.
* The weights are drawn from the seed (``weights``), not R3M's
  checkpoint.

In ``control`` mode the trunk's convolutions take float8 (e4m3) operands
under a per-tensor scale (``common.Precision.low``), one step below the
bfloat16 the configuration states for them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference.common import Precision, dense, step_seed
from perfbench.reference.play_lmp import LOSSES, PlayLMP, _mean_of_shares, batches, held_at_zero

__all__ = ["LOSSES", "make", "weights", "held_at_zero", "train_steps", "batches"]

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the draw stream of the trunk's convolutions (R3M's arXiv number)
BACKBONE_STREAM = 220312601


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channels of (N, C, H, W)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, BN_EPS)


def conv(x: Tensor, layer: nn.Conv2d, p: Precision) -> Tensor:
    return F.conv2d(p.low(x), p.low(layer.weight), None, layer.stride, layer.padding)


class Block(nn.Module):
    def __init__(self, c_in: int, c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(c)
        self.downsample = None
        if stride != 1 or c_in != c:
            self.downsample = nn.Sequential(nn.Conv2d(c_in, c, 1, stride, 0, bias=False), BatchNorm(c))

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        y = F.relu(self.bn1(conv(x, self.conv1, p)))
        y = self.bn2(conv(y, self.conv2, p))
        r = x if self.downsample is None else self.downsample[1](conv(x, self.downsample[0], p))
        return F.relu(y + r)


class Trunk(nn.Module):
    """ResNet-18 without its ``fc``: (N, 3, H, W) -> (N, widths[-1])."""

    def __init__(self, widths: Sequence[int], blocks: Sequence[int]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, widths[0], 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(widths[0])
        c = widths[0]
        self.stages = len(widths)
        for s, (w, n) in enumerate(zip(widths, blocks)):
            self.add_module(f"layer{s + 1}", nn.ModuleList(
                Block(c if b == 0 else w, w, 2 if s > 0 and b == 0 else 1) for b in range(n)))
            c = w

    def forward(self, x: Tensor, p: Precision, pooled: List[Tensor] = None) -> Tensor:
        x = F.max_pool2d(F.relu(self.bn1(conv(x, self.conv1, p))), 3, 2, 1)
        for s in range(self.stages):
            for block in getattr(self, f"layer{s + 1}"):
                x = block(x, p)
            if pooled is not None:
                pooled.append(x.mean(dim=(2, 3)))
        return x.mean(dim=(2, 3))


class R3MEncoder(nn.Module):
    def __init__(self, sizes: dict):
        super().__init__()
        widths = sizes["backbone_widths"]
        if sizes["backbone_features"] != widths[-1]:
            raise ValueError(f"backbone_features {sizes['backbone_features']} is not the last width {widths[-1]}")
        self.backbone = Trunk(widths, sizes["backbone_blocks"])
        self.head1 = nn.Linear(widths[-1], sizes["encoder_hidden_dim"])
        self.head2 = nn.Linear(sizes["encoder_hidden_dim"], sizes["latent_dim"])

    def features(self, x: Tensor, p: Precision, pooled: List[Tensor] = None) -> Tensor:
        """The frozen trunk's features of frames in [-1, 1]."""
        dev = x.device
        shift = torch.tensor([2.0 * m - 1.0 for m in IMAGENET_MEAN], device=dev).view(1, 3, 1, 1)
        scale = torch.tensor([2.0 * s for s in IMAGENET_STD], device=dev).view(1, 3, 1, 1)
        with torch.no_grad():
            return self.backbone((x.float() - shift) / scale, p, pooled)

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        return dense(F.relu(dense(self.features(x, p), self.head1)), self.head2)


class Networks(nn.Module):
    def __init__(self, sizes: dict):
        super().__init__()
        self.networks = nn.ModuleDict({"rgb_static": R3MEncoder(sizes)})


class PlayLMPR3M(PlayLMP):
    """``reference/play_lmp.py``'s network with the R3M encoder; the trunk
    takes no gradient."""

    def __init__(self, sizes: dict):
        super().__init__(sizes)
        self.perceptual_encoder = Networks(sizes)
        self.perceptual_encoder.networks["rgb_static"].backbone.requires_grad_(False)


BACKBONE = "perceptual_encoder.networks.rgb_static.backbone."


def make(sizes: dict) -> PlayLMPR3M:
    return PlayLMPR3M(sizes)


def weights(sizes: dict, seed: int, device) -> dict:
    """The run's weights, all loaded into the program at fit start: the
    head and the rest as ``reference/play_lmp.py`` draws them (uniform in
    +-1/sqrt(fan-in)); the trunk as torchvision initialises a ResNet
    (Kaiming-normal convolutions, fan-out, ReLU gain: std sqrt(2 / (out
    channels x kernel area))), from a stream of its own, with each
    BatchNorm's terms at magnitudes a trained trunk holds: gains uniform
    in [0.5, 1.5], shifts normal with std 0.1, running means normal with
    std 0.1 and running variances uniform in [0.5, 2]. The running
    statistics are in the weights, so a program that leaves out any of the
    four computes other features."""
    from perfbench.weights import make_weights

    net = make(sizes).to(device)
    out = make_weights(net, seed, device, lambda n: n.startswith(BACKBONE) or held_at_zero(n))
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, BACKBONE_STREAM))
    for name, t in net.state_dict().items():
        if not name.startswith(BACKBONE):
            continue
        if t.dim() == 4:
            std = math.sqrt(2.0 / (t.shape[0] * t.shape[2] * t.shape[3]))
            out[name] = torch.randn(t.shape, generator=gen, device=device) * std
        elif name.endswith("weight"):  # a BatchNorm's gain
            out[name] = torch.rand(t.shape, generator=gen, device=device) + 0.5
        elif name.endswith("running_var"):
            out[name] = torch.rand(t.shape, generator=gen, device=device) * 1.5 + 0.5
        else:  # a BatchNorm's shift or running mean
            out[name] = torch.randn(t.shape, generator=gen, device=device) * 0.1
    return {"full": out, "inject": [""]}


def train_steps(weights: Dict[str, Tensor], batches: List[Dict[str, Tensor]], sizes: dict, seed: int,
                first_index: int, mode: str = "f32", ranks: int = 1, exchange: bool = True) -> dict:
    """``reference/play_lmp.py:train_steps`` on this network: each step's
    ``losses``, the first step's ``grads`` of the trained leaves and every
    leaf's ``params`` after the last step, float32 on the weights' device."""
    device = next(iter(weights.values())).device
    p = Precision(mode)
    net = make(sizes).to(device)
    net.load_state_dict(weights)
    net.train()
    named = [(n, q) for n, q in net.named_parameters() if q.requires_grad]
    opt = torch.optim.Adam([q for _, q in named], lr=sizes["lr"], betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=device)
    losses, grads = [], {}
    with p.context():
        for i, batch in enumerate(batches):
            loss = _mean_of_shares(net, named, batch, generator, p, seed, first_index + i, ranks, exchange)
            if i == 0:
                grads = {n: q.grad.detach().clone() for n, q in named}
            opt.step()
            losses.append(loss.detach())
    params = {n: q.detach().clone() for n, q in net.named_parameters()}
    return {"losses": {"total_loss": torch.stack(losses)}, "grads": grads, "params": params}


def stage_rms(sizes: dict, seed: int, frames: Tensor) -> List[float]:
    """The RMS of the trunk's pooled features after each stage, at the
    seed's weights, for augmented frames (N, 3, H, W) in [-1, 1]."""
    net = make(sizes).to(frames.device)
    net.load_state_dict(weights(sizes, seed, frames.device)["full"])
    pooled: List[Tensor] = []
    net.perceptual_encoder.networks["rgb_static"].features(frames, Precision("f32"), pooled)
    return [float(f.square().mean().sqrt()) for f in pooled]
