"""TACO-RL on D4RL states (port of tacorl_tpu/modules/tacorl_d4rl.py;
reference: modules/tacorl/tacorl_d4rl.py:17-173).

Builds from a port Play-LMP D4RL checkpoint (``play_lmp_dir``) at
``lmp_epoch_to_load`` (-1, the default, is the latest step, not the
monitored best): the actor is a copy of the plan proposal on flat
concat(obs_0, goal xy) inputs, acting in the latent-plan space; fresh twin
critics (and targets) of the proposal policy's depth and width unless
``q_network`` says otherwise; the posterior is frozen (no optimizer group,
no gradient) and runs in eval mode (no dropout); the decoder is finetuned
with its own Adam (``action_decoder_lr``) only with
``finetune_action_decoder``, and its loss is a metric of every step.

A step samples a plan from the frozen posterior (gradient stopped), takes
the decoder's imitation step, relabels the window into
(concat(obs_0, goal), plan, concat(obs_T, goal), r = done = goal_reached)
and runs the CQL update on it (``modules/cql.py``). Randomness enters as
data: ``draws`` holds the CQL draws (the plan-space actor has no gripper,
so its draws are ``eps`` only) and ``plan_eps``, the posterior's
(B, latent) standard normal (JAX's k_plan); what is missing comes from the
module's generator.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.modules.cql import CQLModule, CQLNet
from tacorl_tpu_torch.networks.critic import Critic
from tacorl_tpu_torch.networks.late_fusion import build_late_fusion
from tacorl_tpu_torch.networks.layers import reset_parameters
from tacorl_tpu_torch.networks.visual_wrappers import VisualActorWrapper, VisualCriticWrapper

__all__ = ["TACORLD4RLNet", "TACORLD4RLModule"]


class TACORLD4RLNet(CQLNet):
    """state_dict keys: the CQL keys (``actor.actor.policy.*``,
    ``q1.critic.Q.*``, ...) and the LMP's ``plan_recognition.`` and
    ``action_decoder.``."""

    def __init__(
        self, actor, q1, q2, with_lagrange: bool, plan_recognition: nn.Module,
        action_decoder: nn.Module,
    ):
        super().__init__(actor, q1, q2, with_lagrange)
        self.plan_recognition = plan_recognition
        self.action_decoder = action_decoder


def _flat_wrapper(cls, inner):
    """A wrapper that passes flat arrays straight through: an empty fusion
    and no goal encoder."""
    return cls(build_late_fusion({}, []), None, (), (), inner)


class TACORLD4RLModule(CQLModule):
    name = "tacorl_d4rl"

    def build(self) -> None:
        cfg = self.cfg
        self.play_lmp_dir = cfg["play_lmp_dir"]
        self.lmp_epoch_to_load = int(cfg.get("lmp_epoch_to_load", -1))
        self.finetune_action_decoder = bool(cfg.get("finetune_action_decoder", False))
        self.action_decoder_lr = float(cfg.get("action_decoder_lr", 1e-4))
        self.lmp, _ = load_module_from_checkpoint(
            self.play_lmp_dir, step=self.lmp_epoch_to_load,
            overwrite_cfg=cfg.get("overwrite_lmp_cfg") or None, device=self.device,
        )
        cfg.setdefault("action_dim", self.lmp.latent_plan_dim)
        super().build()
        if self.finetune_action_decoder:
            self.group_hparams["action_decoder"] = (self.action_decoder_lr, None)

    def build_networks(self) -> None:
        lmp_net = self.lmp.net
        pp = lmp_net.plan_proposal
        q_cfg = dict(self.cfg.get("q_network", {}))
        q_cls = get_class(q_cfg.pop("_target_", "tacorl_tpu.networks.critic.MLPQNetwork"))
        q_cfg.setdefault("num_layers", pp.policy.num_layers)
        q_cfg.setdefault("hidden_dim", pp.policy.hidden_dim)

        def critic():
            q_net = q_cls(input_dim=pp.state_dim + pp.goal_dim + self.action_dim, **q_cfg)
            return _flat_wrapper(
                VisualCriticWrapper, Critic(q_net, pp.state_dim, pp.goal_dim, self.action_dim)
            )

        decoder = copy.deepcopy(lmp_net.action_decoder)
        if not self.finetune_action_decoder:
            decoder.requires_grad_(False)
        self.net = TACORLD4RLNet(
            _flat_wrapper(VisualActorWrapper, copy.deepcopy(pp)), critic(), critic(),
            self.with_lagrange,
            plan_recognition=copy.deepcopy(lmp_net.plan_recognition).requires_grad_(False),
            action_decoder=decoder,
        )

    def _init_parameters(self) -> None:
        """Fresh critics; the actor, the posterior and the decoder from the
        LMP checkpoint."""
        net, lmp = self.net, self.lmp.net
        reset_parameters(net.q1)
        reset_parameters(net.q2)
        net.actor.actor.load_state_dict(lmp.plan_proposal.state_dict())
        net.plan_recognition.load_state_dict(lmp.plan_recognition.state_dict())
        net.action_decoder.load_state_dict(lmp.action_decoder.state_dict())

    def _group_params(self):
        groups = super()._group_params()
        if self.finetune_action_decoder:
            groups["action_decoder"] = [
                p for p in self.net.action_decoder.parameters() if p.requires_grad
            ]
        return groups

    # -- update --------------------------------------------------------------

    def _update(self, state, batch, scalars, draws, optimize: bool) -> Tuple:
        net, gen = self.net, self.generator
        net.eval()
        metrics: Dict[str, Tensor] = {}
        observations = self._tensor(batch["observations"])
        actions = self._tensor(batch["actions"])
        goal = self._tensor(batch["goal"])
        reached = self._tensor(batch["goal_reached"]).reshape(-1, 1)

        # the frozen posterior's plan: a sample without gradient
        with record_function("tacorl_d4rl/posterior"), torch.no_grad():
            latent_plan = net.plan_recognition(observations).sample(gen, eps=draws.get("plan_eps"))

        with record_function("tacorl_d4rl/decoder"):
            finetune = optimize and self.finetune_action_decoder
            # cuDNN takes an RNN's backward only in train mode; the JAX step
            # applies the decoder with train=False, so the RNN trains with
            # its inter-layer dropout held at 0
            rnn = net.action_decoder.rnn
            rnn_dropout, rnn.dropout = rnn.dropout, 0.0
            rnn.train(finetune)
            try:
                with torch.set_grad_enabled(finetune):
                    dec_loss = net.action_decoder.loss(
                        latent_plan, observations[:, :-1], actions[:, :-1]
                    )
                if finetune:
                    params = state.optimizer.params("action_decoder")
                    state.optimizer.step_group("action_decoder", torch.autograd.grad(dec_loss, params))
            finally:
                rnn.dropout = rnn_dropout
                rnn.eval()
            metrics["action_loss"] = dec_loss.detach()

        metrics["rl_batch_success_rate"] = reached.mean()
        state, cql_metrics = self._cql_update(
            state,
            torch.cat([observations[:, 0], goal], dim=-1),
            torch.cat([observations[:, -1], goal], dim=-1),
            latent_plan, reached, reached, scalars, draws, optimize,
        )
        metrics.update(cql_metrics)
        return state, metrics

    # -- rollout support -------------------------------------------------------

    def make_plan_and_decode_fns(self):
        """Rollout helpers: ``propose(net, obs_goal, draws=None,
        generator=None)``, the actor's deterministic plan for (B, state_dim
        + 2) concat(obs, goal xy) (it draws nothing), and ``decode(net,
        latent_plan, obs, carry, draws=None, generator=None)``, one
        streaming step of the decoder on (B, state_dim) observations;
        returns (actions (B, A), carry)."""

        def propose(net, obs_goal, draws=None, generator=None):
            plan, _ = net.actor.get_actions(
                obs_goal.float(), draws, deterministic=True, generator=generator
            )
            return plan

        def decode(net, latent_plan, obs, carry, draws=None, generator=None):
            action, carry = net.action_decoder.act(
                latent_plan, obs.float()[:, None], None, carry, draws, generator
            )
            return action[:, 0], carry

        return propose, decode
