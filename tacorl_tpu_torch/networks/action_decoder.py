"""Logistic-mixture action decoder (port of ``StackedRNN`` in "rnn" mode
and ``ActionDecoderLogistic`` of tacorl_tpu/networks/action_decoder.py).
state_dict keys follow the reference: ``rnn.{weight,bias}_{ih,hh}_l{i}``,
``mean_fc``, ``log_scale_fc``, ``prob_fc`` and, with a discrete gripper,
``gripper_fc``. The continuous decoder (``discrete_gripper=False``, the
D4RL branch's) has no ``gripper_fc``: every action column is a
logistic-mixture column.

The streaming rollout path (``act``) carries the RNN state explicitly, as
the JAX package does; the carry is ``nn.RNN``'s hidden state,
(num_layers, B, H), where the JAX carry is a tuple of per-layer (B, H).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import (
    logistic_mixture_log_prob,
    logistic_mixture_sample,
)
from tacorl_tpu_torch.networks.layers import TorchDense

LOG_SIG_MIN = -5.0
LOG_SIG_MAX = 2.0
# the interval the JAX sampler draws the mixture uniforms on
_U_MIN, _U_MAX = 1e-5, 1.0 - 1e-5

__all__ = ["StackedRNN", "ActionDecoderLogistic"]


class StackedRNN(nn.RNN):
    """num_layers-deep unidirectional ReLU RNN over (B, T, D), batch-first;
    ``forward`` returns (outputs, final hidden state).

    The JAX layer has no recurrent bias (``h`` carries a kernel only), so
    ``bias_hh_l{i}`` is held at zero and frozen: the port trains the same
    function. A reference checkpoint's non-zero ``bias_hh`` still loads and
    adds into the same pre-activation. Only the "rnn" type is ported."""

    def __init__(
        self,
        rnn_type: str,
        input_size: int,
        hidden_size: int,
        num_layers: int = 2,
        dropout: float = 0.0,
    ):
        if rnn_type != "rnn":
            raise NotImplementedError(
                f"rnn_type {rnn_type!r} is not ported yet (see ROADMAP.md)"
            )
        super().__init__(
            input_size, hidden_size, num_layers, nonlinearity="relu",
            batch_first=True, dropout=dropout,
        )
        for i in range(num_layers):
            getattr(self, f"bias_hh_l{i}").requires_grad_(False)

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                nn.init.zeros_(p)
            else:
                nn.init.uniform_(p, -bound, bound)


def _setup_action_bounds(
    act_max_bound: Sequence[float],
    act_min_bound: Sequence[float],
    discrete_gripper: bool,
):
    """Returns (cont_min (A,1), cont_max (A,1), gripper_bounds (2,) | None)."""
    if discrete_gripper:
        gripper = torch.tensor([act_min_bound[-1], act_max_bound[-1]], dtype=torch.float32)
        act_max_bound = act_max_bound[:-1]
        act_min_bound = act_min_bound[:-1]
    else:
        gripper = None
    lo = torch.tensor(act_min_bound, dtype=torch.float32)[:, None]
    hi = torch.tensor(act_max_bound, dtype=torch.float32)[:, None]
    return lo, hi, gripper


class ActionDecoderLogistic(nn.Module):
    """RNN over [latent_plan; perceptual_emb; (goal)] with a discretized
    logistic-mixture head and, with ``discrete_gripper``, a discrete gripper
    head (the last action column); without it every column is continuous."""

    def __init__(
        self,
        state_dim: int = 32,
        goal_dim: int = 32,
        latent_plan_dim: int = 16,
        hidden_size: int = 256,
        out_features: int = 7,
        act_max_bound: Sequence[float] = (1.0,) * 7,
        act_min_bound: Sequence[float] = (-1.0,) * 7,
        gripper_alpha: float = 1.0,
        policy_rnn_dropout_p: float = 0.0,
        num_layers: int = 2,
        rnn_model: str = "rnn_decoder",
        discrete_gripper: bool = True,
        include_goal: bool = False,
        num_classes: int = 10,
        n_mixtures: int = 10,
        bf16_matmul: bool = False,
        hoisted_rnn: bool = True,
        rnn_unroll: int = 8,
    ):
        super().__init__()
        # hoisted_rnn and rnn_unroll choose how XLA schedules the JAX scan;
        # nn.RNN has its own schedule, so both are accepted and unused.
        if bf16_matmul:
            raise NotImplementedError("bf16_matmul is not ported yet (see ROADMAP.md)")
        self.include_goal = include_goal
        self.discrete_gripper = discrete_gripper
        self.gripper_alpha = gripper_alpha
        self.num_classes = num_classes
        self.n_mixtures = n_mixtures
        self.cont_features = out_features - (1 if discrete_gripper else 0)
        in_features = latent_plan_dim + state_dim + (goal_dim if include_goal else 0)
        self.rnn = StackedRNN(
            rnn_model.replace("_decoder", ""), in_features, hidden_size,
            num_layers, policy_rnn_dropout_p,
        )
        n_out = self.cont_features * n_mixtures
        self.mean_fc = TorchDense(hidden_size, n_out)
        self.log_scale_fc = TorchDense(hidden_size, n_out)
        self.prob_fc = TorchDense(hidden_size, n_out)
        self.gripper_fc = TorchDense(hidden_size, 2) if discrete_gripper else None
        lo, hi, grip = _setup_action_bounds(
            list(act_max_bound), list(act_min_bound), discrete_gripper
        )
        self.register_buffer("action_min_bound", lo, persistent=False)
        self.register_buffer("action_max_bound", hi, persistent=False)
        self.register_buffer("gripper_bounds", grip, persistent=False)

    def forward(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        latent_goal: Optional[Tensor] = None,
        carry: Optional[Tensor] = None,
    ):
        """Returns (logit_probs, log_scales, means, gripper_logits, carry);
        mixture params are (B, T, A, K); gripper_logits is None without a
        discrete gripper."""
        b, s = perceptual_emb.shape[:2]
        parts = [latent_plan[:, None].expand(b, s, latent_plan.shape[-1]), perceptual_emb]
        if self.include_goal:
            parts.append(latent_goal[:, None].expand(b, s, latent_goal.shape[-1]))
        h, carry = self.rnn(torch.cat(parts, dim=-1), carry)
        shape = (b, s, self.cont_features, self.n_mixtures)
        logit_probs = self.prob_fc(h).reshape(shape)
        means = self.mean_fc(h).reshape(shape)
        log_scales = torch.clamp(self.log_scale_fc(h), min=LOG_SIG_MIN).reshape(shape)
        gripper_logits = self.gripper_fc(h) if self.discrete_gripper else None
        return logit_probs, log_scales, means, gripper_logits, carry

    # -- losses ---------------------------------------------------------

    def _logistic_loss(self, logit_probs, log_scales, means, actions) -> Tensor:
        lp = logistic_mixture_log_prob(
            actions, logit_probs, means, log_scales,
            self.action_min_bound, self.action_max_bound,
            self.num_classes, LOG_SIG_MIN,
        )
        return -torch.sum(lp, dim=-1).mean()

    def _loss(self, logit_probs, log_scales, means, gripper_logits, actions) -> Tensor:
        if not self.discrete_gripper:
            return self._logistic_loss(logit_probs, log_scales, means, actions)
        logistics_loss = self._logistic_loss(
            logit_probs, log_scales, means, actions[..., :-1]
        )
        gripper_gt = (actions[..., -1] > 0).long()  # -1 -> 0
        ce = -torch.gather(
            F.log_softmax(gripper_logits, dim=-1), -1, gripper_gt[..., None]
        ).mean()
        return logistics_loss + self.gripper_alpha * ce

    def loss(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        actions: Tensor,
        latent_goal: Optional[Tensor] = None,
    ) -> Tensor:
        """The imitation loss alone (the TACO-RL decoder finetune, the D4RL
        Play-LMP's loss): the mixture NLL, plus the gripper cross-entropy
        with a discrete gripper."""
        logit_probs, log_scales, means, gripper_logits, _ = self(
            latent_plan, perceptual_emb, latent_goal
        )
        return self._loss(logit_probs, log_scales, means, gripper_logits, actions)

    def loss_and_act(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        actions: Tensor,
        latent_goal: Optional[Tensor] = None,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """With a discrete gripper: (loss, predicted gripper action (B, T)).

        The JAX ``loss_and_act`` also draws the continuous action columns
        from the mixture, but the train step reads only the gripper column
        of its prediction, and that column is the argmax of the gripper
        logits mapped to the gripper bounds. So the port computes that
        column directly and makes no continuous draw here.

        Without a discrete gripper: (loss, the mixture sample (B, T, A)),
        ``draws`` and ``generator`` as in ``act``."""
        logit_probs, log_scales, means, gripper_logits, _ = self(
            latent_plan, perceptual_emb, latent_goal
        )
        loss = self._loss(logit_probs, log_scales, means, gripper_logits, actions)
        if not self.discrete_gripper:
            return loss, self._sample(logit_probs, log_scales, means, None, draws, generator)
        pred_gripper = self.gripper_bounds[torch.argmax(gripper_logits, dim=-1)]
        return loss, pred_gripper

    def act(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        latent_goal: Optional[Tensor] = None,
        carry: Optional[Tensor] = None,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Streaming action sampling with an explicit RNN carry (None
        starts from zeros): returns (actions (B, T, A + 1) with a discrete
        gripper, else (B, T, A), and the carry).
        ``draws`` may hold ``u_mix`` (B, T, A, K), the uniforms of the
        Gumbel-max component choice, and ``u`` (B, T, A), those of the
        logistic inversion; what is missing is drawn from ``generator`` on
        [1e-5, 1 - 1e-5), the JAX sampler's interval."""
        logit_probs, log_scales, means, gripper_logits, carry = self(
            latent_plan, perceptual_emb, latent_goal, carry
        )
        return self._sample(logit_probs, log_scales, means, gripper_logits, draws, generator), carry

    def _sample(
        self, logit_probs, log_scales, means, gripper_logits, draws=None, generator=None
    ) -> Tensor:
        """A mixture sample of the continuous columns and, with a discrete
        gripper, the gripper column ``gripper_bounds[argmax(gripper_logits)]``."""
        draws = draws or {}
        u_mix, u = draws.get("u_mix"), draws.get("u")
        if u_mix is None:
            u_mix = _uniform(means.shape, means, generator)
        if u is None:
            u = _uniform(means.shape[:-1], means, generator)
        actions = logistic_mixture_sample(logit_probs, means, log_scales, u_mix, u)
        if not self.discrete_gripper:
            return actions
        grip = self.gripper_bounds[torch.argmax(gripper_logits, dim=-1)]
        return torch.cat([actions, grip[..., None]], dim=-1)


def _uniform(shape, like: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return u * (_U_MAX - _U_MIN) + _U_MIN
