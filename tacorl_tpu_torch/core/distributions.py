"""Probability distributions (port of tacorl_tpu/core/distributions.py).

Randomness enters as data: every sampler takes its standard-normal or
uniform draws as an optional argument, and otherwise draws them from the
``torch.Generator`` it is given. JAX's threefry streams cannot be reproduced
in torch, so the parity tests draw with JAX and pass the draws in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

__all__ = [
    "DiagNormal",
    "TanhNormal",
    "kl_diag_normal",
    "balanced_kl",
    "gumbel_uniform",
    "gumbel_softmax_sample",
    "gumbel_softmax_rsample",
    "gumbel_softmax_log_prob",
    "logistic_mixture_log_prob",
    "logistic_mixture_sample",
]

_LOG2 = math.log(2.0)


def _atanh_clipped(x: Tensor, eps: float = 1e-6) -> Tensor:
    """atanh with the reference's clamping: 0.5 * log((1+x)/(1-x)), both
    terms clamped to >= eps."""
    one_plus = torch.clamp(1.0 + x, min=eps)
    one_minus = torch.clamp(1.0 - x, min=eps)
    return 0.5 * torch.log(one_plus / one_minus)


def _standard_normal(
    shape, like: Tensor, generator: Optional[torch.Generator]
) -> Tensor:
    return torch.randn(
        shape, generator=generator, device=like.device, dtype=like.dtype
    )


@dataclasses.dataclass(frozen=True)
class DiagNormal:
    """Independent Normal over the last axis (event dim = last axis)."""

    mean: Tensor
    std: Tensor

    def log_prob(self, value: Tensor) -> Tensor:
        var = torch.square(self.std)
        lp = -0.5 * (
            torch.square(value - self.mean) / var
            + 2.0 * torch.log(self.std)
            + math.log(2.0 * math.pi)
        )
        return torch.sum(lp, dim=-1)

    def sample(
        self,
        generator: Optional[torch.Generator] = None,
        sample_shape: Tuple[int, ...] = (),
        eps: Optional[Tensor] = None,
    ) -> Tensor:
        """Reparameterised sample ``mean + std * eps`` (gradients flow, as
        in JAX's ``sample``); ``eps`` is drawn when not given."""
        if eps is None:
            eps = _standard_normal(
                tuple(sample_shape) + tuple(self.mean.shape), self.mean, generator
            )
        return self.mean + self.std * eps

    @property
    def mode(self) -> Tensor:
        return self.mean


def kl_diag_normal(p: DiagNormal, q: DiagNormal) -> Tensor:
    """KL(p || q) for independent diagonal normals; sums over the last axis."""
    var_p = torch.square(p.std)
    var_q = torch.square(q.std)
    kl = 0.5 * (
        var_p / var_q
        + torch.square(q.mean - p.mean) / var_q
        - 1.0
        + torch.log(var_q)
        - torch.log(var_p)
    )
    return torch.sum(kl, dim=-1)


def balanced_kl(
    posterior: DiagNormal, prior: DiagNormal, alpha: float = 0.8
) -> Tensor:
    """KL balancing: alpha * KL(sg(posterior) || prior)
    + (1-alpha) * KL(posterior || sg(prior)), with ``detach`` as the stop
    gradient. Returns the per-example KL (the caller takes the mean)."""
    post_sg = DiagNormal(posterior.mean.detach(), posterior.std.detach())
    prior_sg = DiagNormal(prior.mean.detach(), prior.std.detach())
    return alpha * kl_diag_normal(post_sg, prior) + (1.0 - alpha) * kl_diag_normal(
        posterior, prior_sg
    )


@dataclasses.dataclass(frozen=True)
class TanhNormal:
    """X = tanh(Z), Z ~ N(mean, std); event dim = last axis. ``log_prob``
    returns a trailing singleton axis like the reference."""

    mean: Tensor  # pre-tanh mean
    std: Tensor

    @property
    def normal(self) -> DiagNormal:
        return DiagNormal(self.mean, self.std)

    @property
    def mode(self) -> Tensor:
        return torch.tanh(self.mean)

    def sample_with_pretanh(
        self,
        generator: Optional[torch.Generator] = None,
        sample_shape: Tuple[int, ...] = (),
        eps: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor]:
        z = self.normal.sample(generator, sample_shape, eps)
        return torch.tanh(z), z

    def sample(
        self,
        generator: Optional[torch.Generator] = None,
        sample_shape: Tuple[int, ...] = (),
        eps: Optional[Tensor] = None,
    ) -> Tensor:
        return self.sample_with_pretanh(generator, sample_shape, eps)[0]

    def log_prob(
        self, value: Tensor, pre_tanh_value: Optional[Tensor] = None
    ) -> Tensor:
        """Returns shape (..., 1) (keepdim semantics)."""
        if pre_tanh_value is None:
            value = torch.clamp(value, -0.999, 0.999)
            pre_tanh_value = _atanh_clipped(value)
        base = self.normal.log_prob(pre_tanh_value)
        correction = -2.0 * torch.sum(
            _LOG2 - pre_tanh_value - F.softplus(-2.0 * pre_tanh_value), dim=-1
        )
        return (base + correction)[..., None]

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, eps: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor]:
        """Reparameterised sample and its log-density (..., 1)."""
        value, z = self.sample_with_pretanh(generator, eps=eps)
        return value, self.log_prob(value, z)


# ---------------------------------------------------------------------------
# Gumbel softmax (relaxed one-hot categorical)
# ---------------------------------------------------------------------------


def gumbel_uniform(
    shape, like: Tensor, generator: Optional[torch.Generator] = None
) -> Tensor:
    """Uniform draws on (1e-6, 1 - 1e-6), the open interval the JAX
    samplers draw on so that log(-log(u)) stays finite."""
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return u * (1.0 - 2e-6) + 1e-6


def gumbel_softmax_sample(
    logits: Tensor, generator: Optional[torch.Generator] = None, u: Optional[Tensor] = None
) -> Tensor:
    """Hard categorical sample via Gumbel-max; integer indices. ``u`` is
    the uniform draw (shape of ``logits``)."""
    if u is None:
        u = gumbel_uniform(logits.shape, logits, generator)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def gumbel_softmax_rsample(
    logits: Tensor,
    temperature: float = 0.5,
    hard: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[Tensor] = None,
) -> Tensor:
    """Reparameterised relaxed one-hot sample; ``hard`` applies the
    straight-through trick."""
    if u is None:
        u = gumbel_uniform(logits.shape, logits, generator)
    gumbel = -torch.log(-torch.log(u))
    y_soft = torch.softmax((logits + gumbel) / temperature, dim=-1)
    if not hard:
        return y_soft
    index = torch.argmax(y_soft, dim=-1)
    y_hard = F.one_hot(index, logits.shape[-1]).to(y_soft.dtype)
    return (y_hard - y_soft).detach() + y_soft


def gumbel_softmax_log_prob(logits: Tensor, value: Tensor) -> Tensor:
    """sum(value * log_softmax(logits)) with keepdim. ``value`` is one-hot
    or relaxed when its last axis has the class count, else class indices
    (truncated to int, as JAX's astype). The test is JAX's, shape for
    shape: an index vector whose length equals the class count is read as
    one-hot there too."""
    if value.dim() == 0 or value.shape[-1] != logits.shape[-1]:
        value = F.one_hot(value.to(torch.int64), logits.shape[-1]).to(logits.dtype)
    return torch.sum(value * F.log_softmax(logits, dim=-1), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Discretized logistic mixture (PixelCNN++-style), the action-decoder head
# ---------------------------------------------------------------------------


def logistic_mixture_log_prob(
    actions: Tensor,
    logit_probs: Tensor,
    means: Tensor,
    log_scales: Tensor,
    act_min_bound: Tensor,
    act_max_bound: Tensor,
    num_classes: int = 10,
    log_scale_min: float = -5.0,
) -> Tensor:
    """Log-likelihood of ``actions`` under a per-dimension mixture of
    discretized logistics.

    Shapes: actions (..., A); mixture params (..., A, K); bounds (A, 1) or
    broadcastable. Returns the per-element log-prob (..., A). The CDF-edge
    ``where`` chain is the JAX package's, branch for branch."""
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    a = actions[..., None]  # (..., A, 1) broadcast over K
    centered = a - means
    inv_stdv = torch.exp(-log_scales)
    act_range = (act_max_bound - act_min_bound) / 2.0
    half_bin = act_range / (num_classes - 1)

    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    cdf_min = torch.sigmoid(min_in)

    # Edge cases: log CDF at the low edge, log(1-CDF) at the high edge.
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    # Mid-bin PDF fallback when the CDF delta underflows.
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    cdf_delta = cdf_plus - cdf_min

    log_probs = torch.where(
        a < act_min_bound + 1e-3,
        log_cdf_plus,
        torch.where(
            a > act_max_bound - 1e-3,
            log_one_minus_cdf_min,
            torch.where(
                cdf_delta > 1e-5,
                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                log_pdf_mid - math.log((num_classes - 1) / 2.0),
            ),
        ),
    )
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


def logistic_mixture_sample(
    logit_probs: Tensor,
    means: Tensor,
    log_scales: Tensor,
    u_mix: Tensor,
    u: Tensor,
) -> Tensor:
    """Sample actions: Gumbel-max over mixture components, then logistic
    inversion sampling.

    ``u_mix`` (..., A, K) picks the component and ``u`` (..., A) inverts
    the logistic; both are uniform on [1e-5, 1 - 1e-5) as the JAX sampler
    draws them. Shapes: params (..., A, K) -> sample (..., A)."""
    noisy = logit_probs - torch.log(-torch.log(u_mix))
    onehot = F.one_hot(
        torch.argmax(noisy, dim=-1), means.shape[-1]
    ).to(means.dtype)
    sel_log_scales = torch.sum(onehot * log_scales, dim=-1)
    sel_means = torch.sum(onehot * means, dim=-1)
    return sel_means + torch.exp(sel_log_scales) * (torch.log(u) - torch.log(1.0 - u))
