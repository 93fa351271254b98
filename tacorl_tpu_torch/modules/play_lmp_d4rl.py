"""Play-LMP on D4RL state vectors (port of
tacorl_tpu/modules/play_lmp_d4rl.py; reference:
modules/play_lmp/play_lmp_d4rl.py:17-241): no perceptual encoder, raw
observation vectors feed the posterior and the prior directly; the goal is
the xy of the window's last observation; the decoder is the continuous
logistic-mixture decoder over every action column.

The train step runs loss -> backward -> Adam eagerly on the module's device;
the val step computes the same metrics in eval mode and a plan sampled from
the prior. ``random_plan_action_loss`` (the decoder's loss under a uniform
plan in [-1, 1)) is a metric of every step; it is subtracted from the total,
and takes part in the backward, only with ``add_random_plan_loss``, else it
is computed without a graph.

Randomness enters as data: the steps take optional explicit draws (the
posterior's ``eps``, the ``random_plan``, and in the val step the prior's
``pp_eps``); what is not given is drawn from the module's
``torch.Generator``. Dropout (the posterior's, ``dropout_p`` 0.01 by
default) draws from the device's default generator, which the trainer seeds
per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.core.optimizers import reduce_gradients
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.modules.base import AlgorithmModule, seeded_init, step_scalar
from tacorl_tpu_torch.modules.play_lmp import PlayLMPNet, uniform_pm1
from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.networks.layers import reset_parameters

__all__ = ["PlayLMPD4RLNet", "PlayLMPD4RLModule"]

GOAL_DIM = 2  # the goal is an xy position


class PlayLMPD4RLNet(nn.Module):
    """state_dict keys follow the reference PlayLMP D4RL:
    ``plan_recognition``, ``plan_proposal``, ``action_decoder``."""

    def __init__(
        self,
        plan_recognition: nn.Module,
        plan_proposal: Actor,
        action_decoder: nn.Module,
        kl_balancing: bool = True,
        kl_alpha: float = 0.8,
        add_random_plan_loss: bool = False,
    ):
        super().__init__()
        self.plan_recognition = plan_recognition
        self.plan_proposal = plan_proposal
        self.action_decoder = action_decoder
        self.kl_balancing = kl_balancing
        self.kl_alpha = kl_alpha
        self.add_random_plan_loss = add_random_plan_loss

    compute_kl_loss = PlayLMPNet.compute_kl_loss

    def process_batch(self, observations: Tensor):
        """pp_state = the first obs, pp_goal = the last obs's xy
        (play_lmp_d4rl.py:108-115)."""
        pp_dist = self.plan_proposal.get_dist(observations[:, 0], observations[:, -1, :GOAL_DIM])
        return pp_dist, self.plan_recognition(observations)

    def compute_loss(
        self,
        observations: Tensor,
        actions: Tensor,
        kl_beta: float | Tensor,
        eps: Optional[Tensor] = None,
        random_plan: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sample_pp: bool = False,
        pp_eps: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Dict[str, Tensor], Optional[Tensor]]:
        """The ELBO on (B, T, state_dim) windows. ``eps`` (B, latent) is the
        posterior's standard normal, ``random_plan`` (B, latent) the uniform
        plan on [-1, 1) (JAX's k_plan and k_rand). Returns (total_loss,
        metrics, sampled_plan_pp): with ``sample_pp`` a plan from the prior
        (its standard normal ``pp_eps``, JAX's k_pp), else None."""
        pp_dist, pr_dist = self.process_batch(observations)
        kl_loss = self.compute_kl_loss(pr_dist, pp_dist)
        kl_scaled = kl_loss * kl_beta

        obs, acts = observations[:, :-1], actions[:, :-1]
        latent_plan = pr_dist.sample(generator, eps=eps)  # rsample: gradients flow
        action_loss = self.action_decoder.loss(latent_plan, obs, acts)
        random_plan = uniform_pm1(random_plan, pr_dist.mean.shape, obs, generator)
        with torch.set_grad_enabled(self.add_random_plan_loss and torch.is_grad_enabled()):
            random_loss = self.action_decoder.loss(random_plan, obs, acts)
        total = kl_scaled + action_loss
        if self.add_random_plan_loss:
            total = total - random_loss
        metrics = {
            "kl_loss": kl_loss,
            "kl_loss_scaled": kl_scaled,
            "action_loss": action_loss,
            "random_plan_action_loss": random_loss,
            "total_loss": total,
        }
        sampled_plan_pp = pp_dist.sample(generator, eps=pp_eps) if sample_pp else None
        return total, metrics, sampled_plan_pp

    # -- rollout-time pieces ---------------------------------------------------

    def propose_plan(self, obs: Tensor, goal_xy: Tensor):
        """The plan-proposal prior from the current observation and the goal
        xy."""
        return self.plan_proposal.get_dist(obs, goal_xy)

    def recognize_plan(self, observations: Tensor):
        return self.plan_recognition(observations)

    def decode_action(
        self,
        latent_plan: Tensor,
        obs: Tensor,
        carry: Optional[Tensor],
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """One streaming decoder step on (B, state_dim) observations:
        returns (actions (B, A), carry)."""
        action, carry = self.action_decoder.act(latent_plan, obs[:, None], None, carry, draws, generator)
        return action[:, 0], carry


class PlayLMPD4RLModule(AlgorithmModule):
    name = "play_lmp_d4rl"

    def build(self) -> None:
        cfg = self.cfg
        self.latent_plan_dim = int(cfg.get("latent_plan_dim", 16))
        state_dim = int(cfg["state_dim"])
        action_dim = int(cfg.get("action_dim", 8))

        # construction initializes weights from the global CPU RNG; fork it
        # so building a module leaves the caller's stream untouched
        # (init_state re-initializes from its seed)
        with torch.random.fork_rng(devices=[]):
            pr_cfg = dict(cfg.get("plan_recognition", {}))
            pr_cls = get_class(
                pr_cfg.pop("_target_", "tacorl_tpu.networks.plan_recognition.PlanRecognitionTransformer")
            )
            plan_recognition = pr_cls(
                state_dim=state_dim, latent_plan_dim=self.latent_plan_dim, **pr_cfg
            )
            pp_cfg = dict(cfg.get("plan_proposal", {}))
            policy_cfg = dict(pp_cfg.pop("policy", {}))
            policy_cls = get_class(policy_cfg.pop("_target_", "tacorl_tpu.networks.actor.MLPPolicy"))
            plan_proposal = Actor(
                policy=policy_cls(
                    action_dim=self.latent_plan_dim, input_dim=state_dim + GOAL_DIM, **policy_cfg
                ),
                action_dim=self.latent_plan_dim,
                state_dim=state_dim,
                goal_dim=GOAL_DIM,
                **pp_cfg,
            )
            ad_cfg = dict(cfg.get("action_decoder", {}))
            ad_cls = get_class(
                ad_cfg.pop("_target_", "tacorl_tpu.networks.action_decoder.ActionDecoderLogistic")
            )
            ad_cfg.setdefault("out_features", action_dim)
            ad_cfg.setdefault("discrete_gripper", False)
            ad_cfg.setdefault("act_max_bound", [1.0] * action_dim)
            ad_cfg.setdefault("act_min_bound", [-1.0] * action_dim)
            action_decoder = ad_cls(
                state_dim=state_dim, goal_dim=GOAL_DIM, latent_plan_dim=self.latent_plan_dim, **ad_cfg
            )
            self.net = PlayLMPD4RLNet(
                plan_recognition=plan_recognition,
                plan_proposal=plan_proposal,
                action_decoder=action_decoder,
                kl_balancing=bool(cfg.get("kl_balancing", True)),
                kl_alpha=float(cfg.get("kl_alpha", 0.8)),
                add_random_plan_loss=bool(cfg.get("add_random_plan_loss", False)),
            )
        self.lr = float(cfg.get("lr", 1e-4))
        self.kl_beta = float(cfg.get("kl_beta", 1e-3))
        self.generator = torch.Generator(device=self.device)

    # -- schedule ------------------------------------------------------------

    def set_kl_beta(self, kl_beta: float) -> None:
        """KL-schedule callback hook."""
        self.kl_beta = float(kl_beta)

    def step_scalars(self) -> Dict[str, float]:
        return {"kl_beta": self.kl_beta}

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the parameters from ``seed`` (each layer's JAX-package
        init), move them to the device, seed the module's generator and
        make the Adam optimizer (optax.adam's defaults)."""
        with seeded_init(seed, self.device):
            reset_parameters(self.net)
        self.net.to(self.device)
        self.generator.manual_seed(seed)
        params = [p for p in self.net.parameters() if p.requires_grad]
        optimizer = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(step=0, net=self.net, optimizer=optimizer)

    def _inputs(self, batch: Dict[str, Any]) -> Tuple[Tensor, Tensor]:
        return tuple(
            torch.as_tensor(batch[k]).to(self.device, torch.float32) for k in ("observations", "actions")
        )

    # -- steps --------------------------------------------------------------

    def make_train_step(self):
        net, generator = self.net, self.generator

        def train_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            eps: Optional[Tensor] = None,
            random_plan: Optional[Tensor] = None,
        ) -> Tuple[TrainState, Dict[str, Tensor]]:
            """One step: loss -> backward -> Adam, in place on ``state``."""
            scalars = self.step_scalars() if scalars is None else scalars
            net.train()
            obs, actions = self._inputs(batch)
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("play_lmp_d4rl/loss"):
                total, metrics, _ = net.compute_loss(
                    obs, actions, step_scalar(scalars["kl_beta"]), eps=eps, random_plan=random_plan,
                    generator=generator,
                )
            with record_function("play_lmp_d4rl/backward"):
                total.backward()
            with record_function("play_lmp_d4rl/adam"):
                reduce_gradients(net.parameters())  # the mean over the ranks
                state.optimizer.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

        return train_step

    def make_val_step(self):
        net, generator = self.net, self.generator

        def val_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            eps: Optional[Tensor] = None,
            random_plan: Optional[Tensor] = None,
            pp_eps: Optional[Tensor] = None,
        ) -> Tuple[Dict[str, Tensor], Dict[str, Any]]:
            """The loss metrics in eval mode without gradients; the outputs
            hold ``sampled_plan_pp`` (the prior's sample, standard normal
            ``pp_eps``) and the batch's ``idx``."""
            scalars = self.step_scalars() if scalars is None else scalars
            net.eval()
            with torch.no_grad():
                obs, actions = self._inputs(batch)
                _, metrics, sampled_plan_pp = net.compute_loss(
                    obs, actions, step_scalar(scalars["kl_beta"]), eps=eps, random_plan=random_plan,
                    generator=generator, sample_pp=True, pp_eps=pp_eps,
                )
            return metrics, {"sampled_plan_pp": sampled_plan_pp, "idx": batch["idx"]}

        return val_step
