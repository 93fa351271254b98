"""TACO-RL: CQL over frozen latent plans (port of
tacorl_tpu/modules/tacorl.py).

Builds from a port Play-LMP checkpoint (``play_lmp_dir``): the actor is the
LMP plan proposal behind trainable copies of the LMP encoder and goal
encoder, acting in the latent-plan space; fresh twin critics (and targets)
get an encoder that mirrors the LMP encoder; the top-level
``perceptual_encoder``, ``plan_recognition`` and ``goal_encoder`` are
frozen (no optimizer group, no gradient); the ``action_decoder`` is
finetuned with its own Adam when ``finetune_action_decoder`` is set. A step
augments the window and the goal, embeds the window with the frozen
encoder, samples a plan from the frozen posterior, takes the decoder's
imitation step, relabels (s_0, goal, plan, s_T, r = [disp == 1]) and runs
the CQL update on it. Every sub-module runs in eval mode (no dropout), as
the JAX step applies them with their default ``train=False``.

Randomness enters as data: besides the CQL draws (``modules/cql.py``),
``draws`` may hold ``aug_states`` and ``aug_goal`` (DeviceTransforms draws
for the window and the goal; JAX keys k_aug and fold_in(k_aug, 1)) and
``plan_eps``, the posterior's (B, latent_plan_dim) standard normal (k_plan).
The plan-space actor has no gripper, so its draws are ``eps`` only.

The rollout helpers (``make_plan_and_decode_fns``): the actor emits a
deterministic latent plan, the (finetuned) decoder streams actions over the
frozen perceptual encoder's frame embedding.
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
from tacorl_tpu_torch.data.transforms import image_sizes
from tacorl_tpu_torch.modules.cql import CQLModule, CQLNet
from tacorl_tpu_torch.networks.critic import Critic
from tacorl_tpu_torch.networks.late_fusion import build_late_fusion
from tacorl_tpu_torch.networks.layers import reset_parameters
from tacorl_tpu_torch.networks.visual_wrappers import VisualActorWrapper, VisualCriticWrapper

__all__ = ["TACORLNet", "TACORLModule"]

FROZEN = ("perceptual_encoder", "plan_recognition", "goal_encoder")


class TACORLNet(CQLNet):
    """state_dict keys follow the reference TACORL: the CQL keys and the
    LMP's ``perceptual_encoder.``, ``plan_recognition.``,
    ``goal_encoder.``, ``action_decoder.``."""

    def __init__(
        self, actor, q1, q2, with_lagrange: bool, perceptual_encoder: nn.Module,
        plan_recognition: nn.Module, goal_encoder: nn.Module, action_decoder: nn.Module,
    ):
        super().__init__(actor, q1, q2, with_lagrange)
        self.perceptual_encoder = perceptual_encoder
        self.plan_recognition = plan_recognition
        self.goal_encoder = goal_encoder
        self.action_decoder = action_decoder


class TACORLModule(CQLModule):
    name = "tacorl"

    def build(self) -> None:
        cfg = self.cfg
        self.play_lmp_dir = cfg["play_lmp_dir"]
        self.lmp_epoch_to_load = int(cfg.get("lmp_epoch_to_load", -1))
        self.finetune_action_decoder = bool(cfg.get("finetune_action_decoder", False))
        self.action_decoder_lr = float(cfg.get("action_decoder_lr", 1e-4))
        # the pretrained LMP (module + weights) first, so build_networks can
        # graft from it
        self.lmp, self._lmp_state = load_module_from_checkpoint(
            self.play_lmp_dir, step=self.lmp_epoch_to_load,
            overwrite_cfg=cfg.get("overwrite_lmp_cfg") or None, device=self.device,
        )
        cfg.setdefault("action_dim", self.lmp.latent_plan_dim)
        cfg["obs_modalities"] = list(self.lmp.pp_obs)
        cfg["goal_modalities"] = list(self.lmp.pp_goal)
        super().build()
        if self.finetune_action_decoder:
            self.group_hparams["action_decoder"] = (self.action_decoder_lr, None)

    # -- networks ---------------------------------------------------------------

    def build_networks(self) -> None:
        cfg = self.cfg
        lmp_net = self.lmp.net
        pp = lmp_net.plan_proposal
        actor = VisualActorWrapper(
            copy.deepcopy(lmp_net.perceptual_encoder), copy.deepcopy(lmp_net.goal_encoder),
            self.obs_modalities, self.goal_modalities, copy.deepcopy(pp),
        )
        critic_enc_cfg = (cfg.get("critic_encoder") or {}).get("networks")
        if critic_enc_cfg is None:
            critic_enc_cfg = self.lmp.cfg["perceptual_encoder"]["networks"]
        all_mods = list(dict.fromkeys(self.obs_modalities + self.goal_modalities))
        vector_dims = dict(self.lmp.cfg.get("vector_dims", {}))
        q_cfg = dict(cfg.get("q_network", {}))
        q_cls = get_class(q_cfg.pop("_target_", "tacorl_tpu.networks.critic.MLPQNetwork"))
        q_cfg.setdefault("num_layers", pp.policy.num_layers)
        q_cfg.setdefault("hidden_dim", pp.policy.hidden_dim)

        def critic():
            q_net = q_cls(input_dim=pp.state_dim + pp.goal_dim + self.action_dim, **q_cfg)
            return VisualCriticWrapper(
                build_late_fusion(critic_enc_cfg, all_mods, vector_dims, image_sizes(cfg.get("transforms"))),
                copy.deepcopy(lmp_net.goal_encoder), self.obs_modalities, self.goal_modalities,
                Critic(q_net, pp.state_dim, pp.goal_dim, self.action_dim),
            )

        frozen = {k: copy.deepcopy(getattr(lmp_net, k)).requires_grad_(False) for k in FROZEN}
        decoder = copy.deepcopy(lmp_net.action_decoder)
        if not self.finetune_action_decoder:
            decoder.requires_grad_(False)
        self.net = TACORLNet(
            actor, critic(), critic(), self.with_lagrange, action_decoder=decoder, **frozen
        )

    # -- state: graft the pretrained weights ------------------------------------

    def _init_parameters(self) -> None:
        """Fresh critics; the actor, the frozen parts and the decoder from
        the LMP checkpoint; optionally the critics' encoders from the LMP
        too (``init_critic_encoder_from_lmp``, a config-gated extension of
        the JAX package)."""
        net, lmp = self.net, self.lmp.net
        reset_parameters(net.q1)
        reset_parameters(net.q2)
        net.actor.encoder.load_state_dict(lmp.perceptual_encoder.state_dict())
        net.actor.goal_encoder.load_state_dict(lmp.goal_encoder.state_dict())
        net.actor.actor.load_state_dict(lmp.plan_proposal.state_dict())
        for name in FROZEN + ("action_decoder",):
            getattr(net, name).load_state_dict(getattr(lmp, name).state_dict())
        if bool(self.cfg.get("init_critic_encoder_from_lmp", False)):
            for q in (net.q1, net.q2):
                for dst, src in ((q.encoder, lmp.perceptual_encoder), (q.goal_encoder, lmp.goal_encoder)):
                    d, s = dst.state_dict(), src.state_dict()
                    if d.keys() == s.keys() and all(d[k].shape == s[k].shape for k in d):
                        dst.load_state_dict(s)

    def _group_params(self):
        groups = super()._group_params()
        if self.finetune_action_decoder:
            groups["action_decoder"] = [
                p for p in self.net.action_decoder.parameters() if p.requires_grad
            ]
        return groups

    # -- LMP pieces ----------------------------------------------------------------

    def _lmp_embed(self, states: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """(B, T, ...) states -> per-modality (B, T, d) embeddings through the
        frozen perceptual encoder (``PlayLMPNet.get_emb_states``)."""
        b, t = next(iter(states.values())).shape[:2]
        flat = {k: v.reshape((b * t,) + tuple(v.shape[2:])) for k, v in states.items()}
        emb = self.net.perceptual_encoder.encode(
            flat, self.lmp.net.all_modalities, cat_output=False
        )
        return {k: v.reshape(b, t, -1) for k, v in emb.items()}

    # -- update --------------------------------------------------------------------

    def _update(self, state, batch, scalars, draws, optimize: bool) -> Tuple:
        net, gen, lmp = self.net, self.generator, self.lmp
        net.eval()
        metrics: Dict[str, Tensor] = {}
        with record_function("tacorl/augment"):
            states = self.transforms(
                batch["states"], train=optimize, draws=draws.get("aug_states"), generator=gen
            )
            goal = self.transforms(
                batch["goal"], train=optimize, draws=draws.get("aug_goal"), generator=gen
            )
            actions = self._tensor(batch["actions"])
            disp = self._tensor(batch["disp"])

        # the frozen posterior's plan: a sample without gradient
        with record_function("tacorl/posterior"), torch.no_grad():
            emb = self._lmp_embed(states)
            pr_states = torch.cat([emb[m] for m in lmp.pr_mods], dim=-1)
            latent_plan = net.plan_recognition(pr_states).sample(gen, eps=draws.get("plan_eps"))

        # imitation loss of the (finetuned) decoder under the sampled plan
        with record_function("tacorl/decoder"):
            ad_states = torch.cat([emb[m] for m in lmp.ad_mods], dim=-1)
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
                        latent_plan, ad_states[:, :-1], actions[:, :-1]
                    )
                if finetune:
                    params = state.optimizer.params("action_decoder")
                    state.optimizer.step_group("action_decoder", torch.autograd.grad(dec_loss, params))
            finally:
                rnn.dropout = rnn_dropout
                rnn.eval()
            metrics["action_loss"] = dec_loss.detach()

        # relabeled transitions (vectorized get_rl_batch)
        s0 = {m: states[m][:, 0] for m in states}
        s_last = {m: states[m][:, -1] for m in states}
        success = (disp == 1.0).float().reshape(-1, 1)
        metrics["rl_batch_success_rate"] = success.mean()
        state, cql_metrics = self._cql_update(
            state,
            {"observation": s0, "goal": goal},
            {"observation": s_last, "goal": goal},
            latent_plan, success, success, scalars, draws, optimize,
        )
        metrics.update(cql_metrics)
        return state, metrics

    # -- rollout support --------------------------------------------------------------

    def make_plan_and_decode_fns(self):
        """Rollout helpers: ``propose(net, obs, draws=None, generator=None)``,
        the actor's deterministic plan for an {"observation", "goal"} dict
        (it draws nothing), and ``decode(net, latent_plan, obs, carry,
        draws=None, generator=None)``, one streaming step of the decoder
        over the frozen ``perceptual_encoder``'s embedding of the frame;
        returns (actions (B, A + 1), carry)."""
        transforms, ad_mods = self.transforms, self.lmp.ad_mods

        def propose(net, obs, draws=None, generator=None):
            plan, _ = net.actor.get_actions(
                transforms(obs, train=False), draws, deterministic=True, generator=generator
            )
            return plan

        def decode(net, latent_plan, obs, carry, draws=None, generator=None):
            emb = net.perceptual_encoder.encode(transforms(obs, train=False), ad_mods)
            action, carry = net.action_decoder.act(
                latent_plan, emb[:, None], None, carry, draws, generator
            )
            return action[:, 0], carry

        return propose, decode
