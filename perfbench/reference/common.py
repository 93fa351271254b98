"""Plain PyTorch pieces the references share: per-step seeding, the
image augmentation (bilinear resize, DrQ shift, colour jitter, normalize),
the distributions, and the precision modes.

The references import nothing of the program under test and nothing of
JAX. They recompute what the program computes, from the benchmark's own
inputs, in float32 with TF32 off (``mode="f32"``). ``mode="control"``
computes the same one step lower in precision than the configuration
states for each op class: bfloat16 convolutions and resizes in float8
(e4m3) operands under a per-tensor scale, float32 matmuls in TF32, the
TF32-capable recurrence in bfloat16. The control has to come out as not
correct; stage 2's does, on its first step's actor loss (which TF32
matmuls alone move as far), and stage 1's is caught by no number the
program exposes.

A step of W data-parallel ranks is W shares of the global batch, one a
rank, whose gradients are averaged before one update. A rank's share
draws as the whole batch does and keeps its rows (``shard``, ``draw``):
every batch-shaped draw of the step's generator is made at the global
shape and sliced to the rank's rows, so the shares together draw what one
process draws for the global batch; dropout, which cannot draw the global
batch's masks, draws the rank's own from the step's seed with the rank
folded in (``seed_step``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

MODES = ("f32", "control")

# the permutations of (brightness, contrast, hue) a jitter factor row names
PERM_TABLE = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def step_seed(seed: int, index: int) -> int:
    """The 63-bit generator seed of train step ``index`` of a run seeded
    ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def seed_step(generator: torch.Generator, device: torch.device, seed: int, index: int,
              rank: int = 0, ranks: int = 1) -> None:
    """Seed the step's generator and the device's default generator (which
    dropout draws from) for step ``index`` at ``rank`` of ``ranks``: the
    step generator alike on every rank, the default generator from the
    step's seed with the rank folded in (``step_seed(s, rank)``) where there
    is more than one."""
    s = step_seed(seed, index)
    generator.manual_seed(s)
    d = s if ranks == 1 else step_seed(s, rank)
    if device.type == "cuda":
        torch.cuda.default_generators[device.index or torch.cuda.current_device()].manual_seed(d)
    else:
        torch.default_generator.manual_seed(d)


# (rank, ranks) of the share being computed
_SHARD: contextvars.ContextVar = contextvars.ContextVar("perfbench_shard", default=(0, 1))


@contextlib.contextmanager
def shard(rank: int, ranks: int) -> Iterator[None]:
    """Inside: ``draw`` keeps ``rank``'s rows of each global draw."""
    token = _SHARD.set((rank, ranks))
    try:
        yield
    finally:
        _SHARD.reset(token)


def draw(fn, shape) -> Tensor:
    """``fn(shape)``, a draw whose first axis is the batch's; inside
    ``shard(rank, ranks)``, ``fn`` of ``ranks`` times the rows and the
    rank's block of them."""
    rank, ranks = _SHARD.get()
    shape = tuple(int(s) for s in shape)
    if ranks == 1:
        return fn(shape)
    n = shape[0]
    return fn((n * ranks,) + shape[1:])[rank * n:(rank + 1) * n]


def rows_of(batch: dict, rank: int, ranks: int) -> dict:
    """``rank``'s block of rows of every leaf of a global batch."""
    n = next(iter(batch.values())).shape[0] // ranks
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """Both of torch's TF32 switches, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """How each op class computes in a mode: ``conv`` and ``resize``
    operands (the configuration's bfloat16 ops), ``dense`` (float32 with
    TF32 off; the mode's TF32 switch), ``rnn`` (float32 on cuDNN with TF32
    allowed)."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.control = mode == "control"

    def context(self):
        return tf32(self.control)

    def low(self, x: Tensor) -> Tensor:
        """A bfloat16 op's operand: as it is (f32), or rounded to float8
        (e4m3) under a per-tensor scale that maps its largest magnitude to
        float8's largest, as float8 GEMMs scale their operands. The
        gradient passes the rounding unchanged: a plain cast would round
        the gradient to unscaled float8 too, which flushes a convolution's
        gradients (far under float8's least subnormal, 2**-9) to zero and
        leaves its weights unmoved."""
        if not self.control:
            return x
        scale = torch.finfo(torch.float8_e4m3fn).max / x.detach().abs().amax().clamp_min(1e-30)
        rounded = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (rounded - x.detach())

    def rnn(self, x: Tensor) -> Tensor:
        """A recurrence operand: as it is, or rounded to bfloat16."""
        return x.to(torch.bfloat16).float() if self.control else x

    def conv(self, x: Tensor, conv: torch.nn.Conv2d) -> Tensor:
        return F.conv2d(self.low(x), self.low(conv.weight), conv.bias, conv.stride)


def dense(x: Tensor, layer: torch.nn.Linear) -> Tensor:
    return F.linear(x, layer.weight, layer.bias)


# -- augmentation -------------------------------------------------------------------


def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear weights, align_corners=False, no antialias
    (torchvision's tensor Resize): each output pixel blends its two nearest
    source pixels, edges clamped."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(src)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(m, (rows, np.clip(lo, 0, in_size - 1).astype(np.int64)), 1.0 - frac)
    np.add.at(m, (rows, np.clip(lo + 1, 0, in_size - 1).astype(np.int64)), frac)
    return m.astype(np.float32)


def resize_shift(images: Tensor, shifts: Tensor, out_hw, pad: int, p: Precision) -> Tensor:
    """uint8 planar (N, 3, H, W) -> float (N, 3, oh, ow): bilinear resize,
    then the DrQ shift by (dy, dx) in [0, 2 * pad] with edges replicated
    (output pixel y reads resized row clamp(y + dy - pad))."""
    n, _, h, w = images.shape
    oh, ow = out_hw
    dev = images.device
    ry = torch.as_tensor(interp_matrix(h, oh), device=dev)
    rx = torch.as_tensor(interp_matrix(w, ow), device=dev)
    sy = torch.clamp(torch.arange(oh, device=dev)[None] + shifts[:, :1] - pad, 0, oh - 1)
    sx = torch.clamp(torch.arange(ow, device=dev)[None] + shifts[:, 1:] - pad, 0, ow - 1)
    x = p.low(images.float())
    rows = torch.einsum("nyh,nchw->ncyw", p.low(ry[sy]), x)
    return torch.einsum("nxw,ncyw->ncyx", p.low(rx[sx]), p.low(rows))


def jitter_factors(n: int, generator: torch.Generator, brightness: float, contrast: float,
                   hue: float, prob: float) -> Tensor:
    """(n, 8) rows [brightness, contrast, hue, op0, op1, op2, apply, 0],
    drawn in the sampler's order: three uniform factors, the permutation
    code, the apply uniform."""
    dev = generator.device

    def uniform(lo, hi):
        return draw(lambda s: torch.rand(s, generator=generator, device=dev), (n,)) * (hi - lo) + lo

    bf = uniform(max(0.0, 1.0 - brightness), 1.0 + brightness)
    cf = uniform(max(0.0, 1.0 - contrast), 1.0 + contrast)
    hf = uniform(-hue, hue)
    code = draw(lambda s: torch.randint(0, len(PERM_TABLE), s, generator=generator, device=dev), (n,))
    ops = torch.tensor(PERM_TABLE, dtype=torch.float32, device=dev)[code]
    apply = (draw(lambda s: torch.rand(s, generator=generator, device=dev), (n,)) < prob).float()
    return torch.cat([torch.stack([bf, cf, hf], -1), ops, apply[:, None], torch.zeros((n, 1), device=dev)], -1)


def _rgb_to_hsv(rgb: Tensor) -> Tensor:
    r, g, b = rgb.unbind(-3)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta > 0, delta, 1.0)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(torch.where(delta > 0, h, 0.0) / 6.0, 1.0)
    return torch.stack([h, s, maxc], -3)


def _hsv_to_rgb(hsv: Tensor) -> Tensor:
    h, s, v = hsv.unbind(-3)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - f * s), v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    r = torch.where((i == 0) | (i == 5), v, torch.where(i == 1, q, torch.where(i == 4, t, p)))
    g = torch.where((i == 1) | (i == 2), v, torch.where(i == 0, t, torch.where(i == 3, q, p)))
    b = torch.where((i == 3) | (i == 4), v, torch.where(i == 2, t, torch.where(i == 5, q, p)))
    return torch.stack([r, g, b], -3)


def jitter_normalize(x: Tensor, factors: Tensor) -> Tensor:
    """Images in 0..255 -> clip(x / 255), three jitter slots in each
    image's order (brightness, contrast about the grey mean of the image as
    it stands, hue), kept where ``apply``, then (y - 0.5) / 0.5."""
    x = torch.clamp(x * (1.0 / 255.0), 0.0, 1.0)
    bf, cf, hf = (factors[:, k].view(-1, 1, 1, 1) for k in range(3))
    y = x
    for slot in range(3):
        op = factors[:, 3 + slot].to(torch.int32).view(-1, 1, 1, 1)
        bright = torch.clamp(y * bf, 0.0, 1.0)
        grey = 0.2989 * y[:, 0] + 0.587 * y[:, 1] + 0.114 * y[:, 2]
        contr = torch.clamp(cf * y + (1.0 - cf) * grey.mean(dim=(-2, -1)).view(-1, 1, 1, 1), 0.0, 1.0)
        hsv = _rgb_to_hsv(y)
        hue_ = _hsv_to_rgb(torch.stack([torch.remainder(hsv[:, 0] + hf[:, 0], 1.0), hsv[:, 1], hsv[:, 2]], 1))
        y = torch.where(op == 0, bright, torch.where(op == 1, contr, hue_))
    y = torch.where((factors[:, 6] > 0.5).view(-1, 1, 1, 1), y, x)
    return (y - 0.5) / 0.5


def augment_rgb(frames: Tensor, generator: torch.Generator, cfg: dict, p: Precision) -> Tensor:
    """uint8 (..., H, W, 3) frames -> augmented planar float (..., 3, oh,
    ow), the step's draws made in the program's order (shifts, then the
    jitter factors)."""
    lead = frames.shape[:-3]
    flat = frames.reshape((-1,) + frames.shape[-3:]).movedim(-1, -3)
    n, pad = flat.shape[0], int(cfg["pad"])
    shifts = draw(lambda s: torch.randint(0, 2 * pad + 1, s, generator=generator, device=flat.device), (n, 2))
    factors = jitter_factors(n, generator, cfg["brightness"], cfg["contrast"], cfg["hue"], cfg["jitter_prob"])
    out = jitter_normalize(resize_shift(flat, shifts, tuple(cfg["size"]), pad, p), factors)
    return out.reshape(lead + out.shape[1:])


# -- distributions ------------------------------------------------------------------


def kl_normal(mp: Tensor, sp: Tensor, mq: Tensor, sq: Tensor) -> Tensor:
    """KL(N(mp, sp) || N(mq, sq)) summed over the last axis."""
    vp, vq = sp.square(), sq.square()
    return (0.5 * (vp / vq + (mq - mp).square() / vq - 1.0 + torch.log(vq) - torch.log(vp))).sum(-1)


def balanced_kl(post_m, post_s, prior_m, prior_s, alpha: float) -> Tensor:
    return alpha * kl_normal(post_m.detach(), post_s.detach(), prior_m, prior_s) + (1.0 - alpha) * kl_normal(
        post_m, post_s, prior_m.detach(), prior_s.detach()
    )


def logistic_mixture_log_prob(actions: Tensor, logit_probs: Tensor, means: Tensor, log_scales: Tensor,
                              lo: float, hi: float, num_classes: int, log_scale_min: float) -> Tensor:
    """Per-element log-likelihood (..., A) of ``actions`` under a mixture
    (..., A, K) of discretised logistics on [lo, hi] with ``num_classes``
    bins: the CDF mass of the bin, the log CDF at the low edge, log(1 - CDF)
    at the high edge, the mid-bin density where the mass underflows."""
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    a = actions[..., None]
    centered = a - means
    inv = torch.exp(-log_scales)
    half_bin = (hi - lo) / 2.0 / (num_classes - 1)
    plus_in, min_in = inv * (centered + half_bin), inv * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv * centered
    log_probs = torch.where(
        a < lo + 1e-3,
        plus_in - F.softplus(plus_in),
        torch.where(
            a > hi - 1e-3,
            -F.softplus(min_in),
            torch.where(
                cdf_delta > 1e-5,
                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                mid_in - log_scales - 2.0 * F.softplus(mid_in) - math.log((num_classes - 1) / 2.0),
            ),
        ),
    )
    return torch.logsumexp(log_probs + F.log_softmax(logit_probs, -1), -1)


def relu_rnn(x: Tensor, layers, p: Precision, dropout: float = 0.0) -> Tensor:
    """A stack of ReLU RNN layers over (B, T, D) batch-first from a zero
    state: ``layers`` holds (w_ih, b_ih, w_hh, b_hh) of each; h_t =
    relu(x_t W_ih^T + b_ih + b_hh + h_{t-1} W_hh^T), written out step by
    step."""
    h = x
    for w_ih, b_ih, w_hh, b_hh in layers:
        z = F.linear(p.rnn(h), p.rnn(w_ih)) + b_ih + b_hh
        w = p.rnn(w_hh)
        h_t: Optional[Tensor] = None
        outs = []
        for t in range(z.shape[1]):
            h_t = F.relu(z[:, t] if h_t is None else z[:, t] + F.linear(p.rnn(h_t), w))
            outs.append(h_t)
        h = torch.stack(outs, 1)
    return h


def tanh_normal_log_prob(value: Tensor, z: Optional[Tensor], mean: Tensor, std: Tensor) -> Tensor:
    """Log-density (..., 1) of ``value = tanh(z)``, z ~ N(mean, std) per
    column. Without ``z`` it is recovered from the value, clamped to
    +-0.999, each side of the atanh ratio at least 1e-6."""
    if z is None:
        value = torch.clamp(value, -0.999, 0.999)
        z = 0.5 * torch.log(torch.clamp(1.0 + value, min=1e-6) / torch.clamp(1.0 - value, min=1e-6))
    base = (-0.5 * ((z - mean).square() / std.square() + 2.0 * torch.log(std) + math.log(2.0 * math.pi))).sum(-1)
    correction = -2.0 * (math.log(2.0) - z - F.softplus(-2.0 * z)).sum(-1)
    return (base + correction)[..., None]
