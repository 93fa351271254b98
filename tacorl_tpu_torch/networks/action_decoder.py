"""Action decoders (port of ``StackedRNN``, ``ActionDecoderLogistic`` and
``ActionDecoderGaussian`` of tacorl_tpu/networks/action_decoder.py).
state_dict keys follow the reference: ``rnn.{weight,bias}_{ih,hh}_l{i}``
(torch's packed RNN/GRU/LSTM keys; ``rnn.mlp{0,1,2}`` for the MLP
stand-in), then ``mean_fc``, ``log_scale_fc``, ``prob_fc`` and, with a
discrete gripper, ``gripper_fc`` for the logistic head, ``pi_fc``,
``log_var_fc``, ``mu_fc`` for the Gaussian MDN head. The continuous
logistic decoder (``discrete_gripper=False``, the D4RL branch's) has no
``gripper_fc``: every action column is a logistic-mixture column.

The streaming rollout path (``act``) carries the recurrent state
explicitly, as the JAX package does. The carry is the torch module's own:
(num_layers, B, H) for the ReLU RNN and the GRU, the pair (h, c) of those
for the LSTM, and ``()`` for the stateless MLP, where the JAX carry is a
tuple of per-layer (B, H), or of per-layer (c, h) for the LSTM. Agents
treat it as opaque (``evaluation/agents.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import (
    DiagNormal,
    logistic_mixture_log_prob,
    logistic_mixture_sample,
)
from tacorl_tpu_torch.networks.layers import TorchDense
from tacorl_tpu_torch.parallel.mesh import draw_rows

LOG_SIG_MIN = -5.0
LOG_SIG_MAX = 2.0
# the interval the JAX sampler draws the mixture uniforms on
_U_MIN, _U_MAX = 1e-5, 1.0 - 1e-5

__all__ = ["StackedRNN", "ActionDecoderLogistic", "ActionDecoderGaussian"]


def StackedRNN(rnn_type: str, input_size: int, hidden_size: int, num_layers: int = 2,
               dropout: float = 0.0, bf16_matmul: bool = False) -> nn.Module:
    """num_layers-deep unidirectional RNN over (B, T, D), batch-first;
    ``forward(x, carry=None)`` returns (outputs, final carry).

    ``rnn_type`` picks the module: ``"rnn"`` a ReLU ``nn.RNN``, ``"gru"``
    an ``nn.GRU``, ``"lstm"`` an ``nn.LSTM`` (cuDNN on the card) and
    ``"mlp"`` three ``TorchDense`` layers (ReLU, ReLU, none), stateless
    (``bf16_matmul`` is the ReLU RNN's option). Each computes the flax cell
    of the JAX package, whose biases sit on fewer terms than torch's;
    torch's extra biases are held at zero and take no gradient, so the port
    trains the same function (a reference checkpoint's non-zero values
    still load and add in):

      * ReLU RNN: the JAX layer has no recurrent bias; ``bias_hh_l{i}`` is
        frozen.
      * GRU: flax's ``GRUCell`` biases ``ir``/``iz``/``in`` and ``hn``, not
        ``hr``/``hz``; the r and z thirds of ``bias_hh_l{i}`` are zeroed in
        its gradient by a hook (the n third trains).
      * LSTM: flax's ``OptimizedLSTMCell`` biases the ``h`` side only;
        ``bias_ih_l{i}`` is frozen.

    Every weight and trained bias starts uniform in +-1/sqrt(hidden_size),
    the JAX init."""
    if rnn_type not in _RNN_TYPES:
        raise ValueError(f"unknown rnn_type {rnn_type!r}")
    if rnn_type == "rnn":
        return _ReLURNN(input_size, hidden_size, num_layers, dropout, bf16_matmul)
    return _RNN_TYPES[rnn_type](input_size, hidden_size, num_layers, dropout)


def _jax_init(rnn: nn.RNNBase, held: str) -> None:
    """Every parameter uniform in +-1/sqrt(hidden_size), then the biases
    the flax cell lacks (``held``: ``bias_hh``, ``bias_ih``, or the GRU's
    ``bias_hh_rz``, the r and z thirds) zeroed."""
    bound = 1.0 / math.sqrt(rnn.hidden_size)
    for p in rnn.parameters():
        nn.init.uniform_(p, -bound, bound)
    for i in range(rnn.num_layers):
        bias = getattr(rnn, f"{held[:7]}_l{i}")
        nn.init.zeros_(bias[: 2 * rnn.hidden_size] if held == "bias_hh_rz" else bias)


class _ReLURNN(nn.RNN):
    """The ReLU RNN. ``bf16_matmul`` (the JAX ``_HoistedSimpleRNNLayer``'s
    mixed precision): the input projection of the whole window runs with
    bfloat16 operands and a bfloat16 result, the recurrence with bfloat16
    operands, a float32 result and a float32 carry; the layers then run in
    a Python loop over time rather than in cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float, bf16_matmul: bool):
        super().__init__(input_size, hidden_size, num_layers, nonlinearity="relu", batch_first=True,
                         dropout=dropout)
        self.bf16_matmul = bool(bf16_matmul)
        for i in range(num_layers):
            getattr(self, f"bias_hh_l{i}").requires_grad_(False)

    def reset_parameters(self) -> None:
        _jax_init(self, "bias_hh")

    def forward(self, x: Tensor, carry: Optional[Tensor] = None):
        if not self.bf16_matmul:
            return super().forward(x, carry)
        h = x
        finals = []
        for i in range(self.num_layers):
            w_ih, b_ih, w_hh, b_hh = (
                getattr(self, f"{n}_l{i}") for n in ("weight_ih", "bias_ih", "weight_hh", "bias_hh")
            )
            # flax Dense(dtype=bfloat16): operands, product and bias in bf16
            z = (F.linear(h.to(torch.bfloat16), w_ih.to(torch.bfloat16))
                 + b_ih.to(torch.bfloat16)).float() + b_hh
            wh_t = w_hh.to(torch.bfloat16).t()
            h_t = carry[i] if carry is not None else z.new_zeros(z.shape[0], self.hidden_size)
            outs = []
            for t in range(z.shape[1]):
                h_t = F.relu(z[:, t] + bf16_mm(h_t, wh_t))
                outs.append(h_t)
            h = torch.stack(outs, dim=1)
            finals.append(h_t)
            if self.dropout > 0.0 and i < self.num_layers - 1:
                h = F.dropout(h, self.dropout, self.training)
        return h, torch.stack(finals)


def _mm_f32(a16: Tensor, b16: Tensor) -> Tensor:
    """bfloat16 operands, float32 result: ``torch.mm`` with ``out_dtype``
    on the card; on the CPU, which has no such kernel, the product of the
    operands upcast to float32 (the same numbers: a product of two bfloat16
    values is exact in float32)."""
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


class _BF16MM(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` has no derivative in torch; the
    backward takes the same mixed precision: the float32 cotangent rounded
    to bfloat16, float32 products, each gradient rounded to its input's
    bfloat16 (as JAX's transpose of the dot converts it to the operand's
    dtype)."""

    @staticmethod
    def forward(ctx, a16: Tensor, b16: Tensor) -> Tensor:
        ctx.save_for_backward(a16, b16)
        return _mm_f32(a16, b16)

    @staticmethod
    def backward(ctx, grad: Tensor):
        a16, b16 = ctx.saved_tensors
        g16 = grad.to(torch.bfloat16)
        ga = _mm_f32(g16, b16.t()).to(torch.bfloat16) if ctx.needs_input_grad[0] else None
        gb = _mm_f32(a16.t(), g16).to(torch.bfloat16) if ctx.needs_input_grad[1] else None
        return ga, gb


def bf16_mm(a: Tensor, b_bf16: Tensor) -> Tensor:
    """``a @ b`` with bfloat16 operands and a float32 result (the JAX
    ``lax.dot(..., preferred_element_type=float32)``)."""
    return _BF16MM.apply(a.to(torch.bfloat16), b_bf16)


def _zero_rz_grad(grad: Tensor) -> Tensor:
    third = grad.shape[0] // 3
    return torch.cat((torch.zeros_like(grad[: 2 * third]), grad[2 * third :]))


class _GRU(nn.GRU):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True, dropout=dropout)
        self._hold_rz_biases()

    def _hold_rz_biases(self) -> None:
        for i in range(self.num_layers):
            getattr(self, f"bias_hh_l{i}").register_hook(_zero_rz_grad)

    def __setstate__(self, state) -> None:
        # a copy's parameters are new tensors, without the hooks
        super().__setstate__(state)
        self._hold_rz_biases()

    def reset_parameters(self) -> None:
        _jax_init(self, "bias_hh_rz")


class _LSTM(nn.LSTM):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True, dropout=dropout)
        for i in range(num_layers):
            getattr(self, f"bias_ih_l{i}").requires_grad_(False)

    def reset_parameters(self) -> None:
        _jax_init(self, "bias_ih")


class _MLP(nn.Module):
    """rnn_models.mlp_decoder: three layers, ReLU after the first two; the
    carry is ``()``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float):
        super().__init__()
        self.hidden_size = hidden_size
        self.mlp0 = TorchDense(input_size, hidden_size)
        self.mlp1 = TorchDense(hidden_size, hidden_size)
        self.mlp2 = TorchDense(hidden_size, hidden_size)

    def forward(self, x: Tensor, carry=None):
        return self.mlp2(F.relu(self.mlp1(F.relu(self.mlp0(x))))), ()


_RNN_TYPES = {"rnn": _ReLURNN, "gru": _GRU, "lstm": _LSTM, "mlp": _MLP}


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
        # torch's RNNs have their own schedule, so both are accepted and
        # unused, except that the JAX package takes the bf16 recurrence
        # only on its hoisted ReLU-RNN path (as here: "rnn" only).
        self.include_goal = include_goal
        self.discrete_gripper = discrete_gripper
        self.gripper_alpha = gripper_alpha
        self.num_classes = num_classes
        self.n_mixtures = n_mixtures
        self.cont_features = out_features - (1 if discrete_gripper else 0)
        in_features = latent_plan_dim + state_dim + (goal_dim if include_goal else 0)
        self.rnn = StackedRNN(
            rnn_model.replace("_decoder", ""), in_features, hidden_size,
            num_layers, policy_rnn_dropout_p, bf16_matmul=bf16_matmul and hoisted_rnn,
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
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=like.device, dtype=like.dtype), shape)
    return u * (_U_MAX - _U_MIN) + _U_MIN


class ActionDecoderGaussian(nn.Module):
    """RNN (an LSTM by default) over [latent_plan; perceptual_emb; (goal)]
    with a Gaussian mixture-density head: ``log_pi`` (B, T, K) from
    ``pi_fc``, ``sigma`` = exp(clip(``log_var_fc``, -5, 2)) and ``mu``, each
    (B, T, K, out_features). The head has no gripper logits: every action
    column, the gripper's included, is a mixture column.

    ``_sample`` picks a component per (b, t) as ``jax.random.categorical``
    does, the argmax of ``log_pi`` plus Gumbel noise, then returns
    ``mu + sigma * eps`` of that component. ``draws`` may hold ``gumbel``
    (B, T, K), the Gumbel noise (JAX's ``gumbel`` of the first half of the
    split key), and ``eps`` (B, T, out_features), the standard normals (of
    the second half); what is missing is drawn from ``generator``."""

    def __init__(
        self,
        state_dim: int = 32,
        goal_dim: int = 32,
        latent_plan_dim: int = 16,
        hidden_size: int = 256,
        out_features: int = 7,
        policy_rnn_dropout_p: float = 0.0,
        num_layers: int = 2,
        rnn_model: str = "lstm_decoder",
        n_mixtures: int = 10,
        include_goal: bool = False,
        discrete_gripper: bool = False,
    ):
        super().__init__()
        self.include_goal = include_goal
        self.discrete_gripper = discrete_gripper
        self.out_features = out_features
        self.n_mixtures = n_mixtures
        in_features = latent_plan_dim + state_dim + (goal_dim if include_goal else 0)
        self.rnn = StackedRNN(
            rnn_model.replace("_decoder", ""), in_features, hidden_size, num_layers,
            policy_rnn_dropout_p,
        )
        self.pi_fc = TorchDense(hidden_size, n_mixtures)
        self.log_var_fc = TorchDense(hidden_size, out_features * n_mixtures)
        self.mu_fc = TorchDense(hidden_size, out_features * n_mixtures)

    def forward(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        latent_goal: Optional[Tensor] = None,
        carry=None,
    ):
        """Returns (log_pi (B, T, K), sigma (B, T, K, O), mu (B, T, K, O),
        carry)."""
        b, s = perceptual_emb.shape[:2]
        parts = [latent_plan[:, None].expand(b, s, latent_plan.shape[-1]), perceptual_emb]
        if self.include_goal and latent_goal is not None:
            parts.append(latent_goal[:, None].expand(b, s, latent_goal.shape[-1]))
        h, carry = self.rnn(torch.cat(parts, dim=-1), carry)
        log_pi = F.log_softmax(self.pi_fc(h), dim=-1)
        shape = (b, s, self.n_mixtures, self.out_features)
        sigma = torch.exp(torch.clamp(self.log_var_fc(h), LOG_SIG_MIN, LOG_SIG_MAX)).reshape(shape)
        mu = self.mu_fc(h).reshape(shape)
        return log_pi, sigma, mu, carry

    def log_prob(self, log_pi: Tensor, sigma: Tensor, mu: Tensor, target: Tensor) -> Tensor:
        """The mixture's log-density of ``target`` (B, T, O): (B, T)."""
        comp_lp = DiagNormal(mu, sigma).log_prob(target[..., None, :])
        return torch.logsumexp(log_pi + comp_lp, dim=-1)

    def loss(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        actions: Tensor,
        latent_goal: Optional[Tensor] = None,
    ) -> Tensor:
        """The mixture NLL, averaged over (B, T)."""
        log_pi, sigma, mu, _ = self(latent_plan, perceptual_emb, latent_goal)
        return -self.log_prob(log_pi, sigma, mu, actions).mean()

    def loss_and_act(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        actions: Tensor,
        latent_goal: Optional[Tensor] = None,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """(loss, a mixture sample (B, T, O)); ``draws`` as in ``_sample``."""
        log_pi, sigma, mu, _ = self(latent_plan, perceptual_emb, latent_goal)
        loss = -self.log_prob(log_pi, sigma, mu, actions).mean()
        return loss, self._sample(log_pi, sigma, mu, draws, generator)

    def act(
        self,
        latent_plan: Tensor,
        perceptual_emb: Tensor,
        latent_goal: Optional[Tensor] = None,
        carry=None,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Streaming sampling with an explicit carry (None starts from
        zeros): returns (actions (B, T, O), carry)."""
        log_pi, sigma, mu, carry = self(latent_plan, perceptual_emb, latent_goal, carry)
        return self._sample(log_pi, sigma, mu, draws, generator), carry

    def _sample(self, log_pi, sigma, mu, draws=None, generator=None) -> Tensor:
        draws = draws or {}
        gumbel, eps = draws.get("gumbel"), draws.get("eps")
        if gumbel is None:
            # jax.random.gumbel: -log(-log(U)), U uniform on [tiny, 1)
            u = draw_rows(
                lambda s: torch.rand(s, generator=generator, device=log_pi.device, dtype=log_pi.dtype),
                log_pi.shape,
            )
            gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        if eps is None:
            eps = draw_rows(
                lambda s: torch.randn(s, generator=generator, device=mu.device, dtype=mu.dtype),
                mu.shape[:-2] + mu.shape[-1:],
            )
        comp = torch.argmax(log_pi + gumbel.to(log_pi), dim=-1)  # (B, T)
        idx = comp[..., None, None].expand(comp.shape + (1, mu.shape[-1]))
        sel_mu = torch.gather(mu, -2, idx)[..., 0, :]
        sel_sigma = torch.gather(sigma, -2, idx)[..., 0, :]
        return sel_mu + sel_sigma * eps.to(mu)
